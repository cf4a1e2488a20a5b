"""Spans and counters of the port's own work: off by default.

A span names a stretch of the program (``span(name, device)``), entered
as a context manager where the work happens: the serving engine's steps
(``serve.*``), the captured steps (``graph.*``) and the parts of a
transformer block (``attn.qkv``, ``attn.core``, ``attn.out``, ``mlp``,
``embed``, ``head``).  With tracing off, which is the default, a span only
tests a flag and does nothing else; an ``outer`` span (the engine's and the
graphs') is also entered as a ``torch.profiler.record_function`` range
whenever a torch profiler is recording, so a profile names the host's time
by what the engine was doing.

With tracing on (``with enabled():``), a span

* opens a ``record_function`` range, on the profiler's clock;
* times its work on its device: on a CUDA device by a pair of timing
  events (``external=True``) recorded on the current stream, which under
  stream capture become event-record nodes of the graph and time every
  replay of it; on any other device (the CPU runs its ops before they
  return) by the host's clock.

The times are kept in memory.  A span with ``outer=True`` and a device is a
*step* (``serve.prefill``, ``serve.decode``, ...): each occurrence is one
record under its own name, and every other timed span inside it adds its
time to that step as a part, ``"<step>/<name>"``.  A timed span outside any
step is a record of its own.  ``records()`` lists them; ``spans()`` gives
each name's ms, one number a step (a part's times summed over the step,
the layers of a model summed by name).

A captured step's events are the graph's own, and its next replay
overwrites them.  So a traced ``CudaGraphStep`` (``spans=True``) captured
with tracing on keeps the
events recorded during its capture (``capturing``) and reports each replay
(``replayed``); they are read just before that graph replays again
(``flush(events)``), or by ``records()``.  Reading waits for the replay:
a traced signature has two graphs replayed in turns, so the host waits
for the replay before last while the card runs the last one.

Counters are host numbers, read by ``snapshot()``: the graphs' captures,
their ms and replays (read from every live ``CudaGraphStep``, whose own
record they are), the wrappers' launches those replays stood for
(``launches.<name>``, read from each graph's kernel nodes), and the kernels
built from source in this process (``count``, from ``kernels._build``).
A tally (``tally``) counts on the device: with tracing on, each value of
an index tensor (a MoE layer's routed experts, ``moe.pairs``) is added to
a counter tensor in place, inside a captured step's graph as in eager
work; ``snapshot`` reads it, with its max and mean, and ``reset`` zeroes it.
The counters are slices of one buffer a device (``_TALLY_SLOTS`` entries),
made outside any capture: by ``enabled()`` on the current CUDA device. A
tensor made inside a capture would come from the graph pool, whose other
graphs' replays may write over it.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from typing import Any, Iterator

import torch

__all__ = ["capturing", "count", "enabled", "flush", "is_on", "records", "replayed", "reset",
           "snapshot", "span", "spans", "tally", "watch"]

_NULL = contextlib.nullcontext()
_TALLY_SLOTS = 4096  # int64 tally entries a device


class _State:
    """The process's tracing state: the switch, the open steps, the records
    and the counters."""

    def __init__(self) -> None:
        self.on = False
        self.steps: list[dict] = []  # the open step spans, innermost last
        self.records: list[dict] = []
        self.unread: list[tuple[list, list]] = []  # (a graph's events, where they go)
        self.sink: list | None = None  # the events of the capture in progress
        self.counters: dict[str, float] = {}
        self.tallies: dict[str, torch.Tensor] = {}  # device counters (``tally``)
        self.slots: dict[torch.device, tuple[torch.Tensor, int]] = {}  # (buffer, slots used)
        self.graphs: weakref.WeakSet = weakref.WeakSet()


_S = _State()


def is_on() -> bool:
    return _S.on


@contextlib.contextmanager
def enabled() -> Iterator[None]:
    """Tracing on for the block (and back to what it was after)."""
    was, _S.on = _S.on, True
    if torch.cuda.is_available():
        _slots(torch.device("cuda", torch.cuda.current_device()))
    try:
        yield
    finally:
        _S.on = was


def span(name: str, device: torch.device | None = None, *, outer: bool = False,
         after: _Span | None = None):
    """A context manager naming a stretch of work (see the module's
    docstring); ``device`` is where the work runs, ``None`` for a host
    range that times nothing.  ``after`` (what the ``with`` of a span
    just closed gave, ``None`` with tracing off) starts this span at that
    one's end mark, for work that follows it with nothing between: one
    event node fewer in a captured graph, where each costs ~3.7 us of
    device time (H100)."""
    if _S.on:
        return _Span(name, device, outer, after)
    if outer and torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


class _Span:
    __slots__ = ("name", "device", "outer", "after", "range", "start", "end", "record")

    def __init__(self, name: str, device, outer: bool, after: _Span | None) -> None:
        self.name, self.outer, self.after = name, outer, after
        self.device = None if device is None else torch.device(device)
        self.record = self.end = None

    def __enter__(self) -> _Span:
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        after = self.after
        self.start = after.end if after is not None and after.end is not None else self._mark()
        if self.outer and self.start is not None:
            self.record = {"name": self.name, "ms": None, "parts": []}
            _S.steps.append(self.record)
        return self

    def __exit__(self, *exc) -> None:
        self.end = end = self._mark()
        self.range.__exit__(*exc)
        if self.start is None:
            return
        timing = (self.start, end)
        if self.record is not None:
            _S.steps.remove(self.record)
            self.record["ms"] = timing
            _S.records.append(self.record)
        elif torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            _S.sink.append((self.name, *timing))
        elif _S.steps:
            _S.steps[-1]["parts"].append((self.name, timing))
        else:
            _S.records.append({"name": self.name, "ms": timing, "parts": []})

    def _mark(self):
        """A timing event recorded on the device's current stream, or the
        host's clock off CUDA; ``None`` when nothing is timed (no device, or a
        capture that no ``CudaGraphStep`` will read)."""
        if self.device is None:
            return None
        if self.device.type != "cuda":
            return time.perf_counter()
        if torch.cuda.is_current_stream_capturing() and _S.sink is None:
            return None
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record(torch.cuda.current_stream(self.device))
        return event


@contextlib.contextmanager
def capturing(events: list | None) -> Iterator[None]:
    """Spans timed during the block (a CUDA graph's capture) append
    ``(name, start event, end event)`` to ``events``: the graph's nodes
    (``None``: a capture whose spans time nothing)."""
    was, _S.sink = _S.sink, events
    try:
        yield
    finally:
        _S.sink = was


def replayed(events: list) -> None:
    """A graph captured with ``events`` was just replayed: its spans are
    parts of the open step (each its own record outside a step), read by a
    later ``flush``."""
    if events:
        _S.unread.append((events, _S.steps[-1]["parts"] if _S.steps else None))


def flush(events: list | None = None) -> None:
    """Read the replayed graphs' events (those of the graph captured with
    ``events``, or every graph's), waiting for their replays to end."""
    left = []
    for evs, parts in _S.unread:
        if events is not None and evs is not events:
            left.append((evs, parts))
            continue
        evs[-1][2].synchronize()
        got = [(name, a.elapsed_time(b)) for name, a, b in evs]
        if parts is None:
            _S.records.extend({"name": name, "ms": ms, "parts": []} for name, ms in got)
        else:
            parts.extend(got)
    _S.unread[:] = left


def _ms(timing: Any) -> float:
    if isinstance(timing, float):
        return timing
    a, b = timing
    if isinstance(a, float):
        return (b - a) * 1e3
    b.synchronize()
    return a.elapsed_time(b)


def records() -> list[dict]:
    """Every finished record, in the order they closed: ``{"name", "ms",
    "parts"}``, ``parts`` a list of (name, ms) in the order they ran (a
    step's; empty for any other span)."""
    flush()
    out = []
    for rec in _S.records:
        out.append({"name": rec["name"], "ms": _ms(rec["ms"]),
                    "parts": [(name, _ms(t)) for name, t in rec["parts"]]})
    return out


def spans() -> dict[str, list[float]]:
    """Device ms of each span name, one number a record: a step's own
    (``"serve.decode"``), its parts summed by name (``"serve.decode/mlp"``:
    every layer's ``mlp`` in that step), a span outside any step its own."""
    out: dict[str, list[float]] = {}
    for rec in records():
        out.setdefault(rec["name"], []).append(rec["ms"])
        summed: dict[str, float] = {}
        for name, ms in rec["parts"]:
            summed[name] = summed.get(name, 0.0) + ms
        for name, ms in summed.items():
            out.setdefault(f"{rec['name']}/{name}", []).append(ms)
    return out


def reset() -> None:
    """Drop every record and zero the tallies (the counters stay)."""
    flush()
    _S.records.clear()
    for acc in _S.tallies.values():
        acc.zero_()


def _slots(device: torch.device) -> tuple[torch.Tensor, int]:
    """The device's tally buffer and the slots used, made zeroed on first
    use (never inside a capture)."""
    got = _S.slots.get(device)
    if got is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"no tally buffer on {device}: enter trace.enabled() with it "
                               "current, before any capture")
        got = _S.slots[device] = (torch.zeros(_TALLY_SLOTS, dtype=torch.int64, device=device), 0)
    return got


def tally(name: str, index: torch.Tensor, size: int) -> None:
    """With tracing on, add one to the tally ``name``, ``size`` int64
    counters on ``index``'s device, at each value of ``index`` (ints below
    ``size``), in place: under a stream capture the add is a node of the
    graph, and each replay adds again."""
    if not _S.on:
        return
    acc = _S.tallies.get(name)
    if acc is None or acc.shape[0] != size or acc.device != index.device:
        buf, used = _slots(index.device)
        if used + size > _TALLY_SLOTS:
            raise RuntimeError(f"tally {name!r}: {size} more slots than the {_TALLY_SLOTS} a device")
        acc = _S.tallies[name] = buf[used : used + size]
        _S.slots[index.device] = (buf, used + size)
    flat = index.reshape(-1).long()
    acc.index_add_(0, flat, torch.ones_like(flat))


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _S.counters[name] = _S.counters.get(name, 0) + n


def watch(step: Any) -> None:
    """Count a ``CudaGraphStep``'s captures and replays in ``snapshot``
    while it lives."""
    _S.graphs.add(step)


def snapshot() -> dict[str, Any]:
    """The counters: ``graph.captures``, ``graph.capture_ms`` and
    ``graph.replays`` over the live ``CudaGraphStep``s, and the wrappers'
    launches their replays stood for (``launches.<name>``, their
    ``replayed``); every ``count`` (``kernels.builds.<name>``,
    ``kernels.build_s``); each tally as a list of ints, and its
    ``<name>.max`` and ``<name>.mean`` (read from the device: a wait)."""
    graphs = list(_S.graphs)
    caps = [c for g in graphs for c in g.captures]
    out: dict[str, Any] = {
        "graph.captures": len(caps), "graph.capture_ms": sum(c["ms"] for c in caps),
        "graph.replays": sum(e.replays for g in graphs for e in g.graphs.values())}
    for g in graphs:
        for name, n in getattr(g, "replayed", {}).items():
            out[f"launches.{name}"] = out.get(f"launches.{name}", 0) + n
    out.update(_S.counters)
    for name, acc in sorted(_S.tallies.items()):
        got = acc.tolist()
        out[name] = got
        out[f"{name}.max"] = max(got)
        out[f"{name}.mean"] = sum(got) / len(got)
    return out
