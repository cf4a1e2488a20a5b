"""The program's own spans and counters (``repro_torch.trace``), read once a
run for the per-layer metrics that name them.

A traced run reads its other per-layer metrics first, with tracing off. Then
the first reader that asks switches the program's tracing on
(``trace.enabled()``) and runs, on the cell's batch, either

* ``prefill``: ``prefill_reps`` calls of ``engine.prefill`` (the prefill
  cells), or
* ``generate``: ``trace_calls`` whole ``engine.generate`` calls (the decode
  cells),

after two calls of the same work that capture the traced graphs (two a
signature with its spans' timing events, replayed in turns, beside the
untraced one) and are not read. It then reads ``trace.spans()`` (device
ms, one number a step: ``serve.decode``, ``serve.decode/attn.core``
summed over the layers) and ``trace.snapshot()``, switches tracing off,
and prints both as a table on standard error once. The result is cached
on the run.

Nothing is read (``None``) without a card, or from a program that has no
``repro_torch.trace``.
"""

from __future__ import annotations

import statistics
import sys

_KEY = "_bench_spans"


def read(run, kind: str) -> dict | None:
    """``{"spans": {name: [ms, ...]}, "counters": {...}}`` of ``kind``
    (``"prefill"`` or ``"generate"``), measured on first use."""
    cache = run.__dict__.setdefault(_KEY, {})
    if kind not in cache:
        cache[kind] = _measure(run, kind) if run.device.type == "cuda" else None
    return cache[kind]


def median(run, kind: str, name: str) -> float | None:
    """The median of span ``name``'s ms over the steps of ``kind``'s calls."""
    got = read(run, kind)
    if got is None or not got["spans"].get(name):
        return None
    return statistics.median(got["spans"][name])


def _measure(run, kind: str) -> dict | None:
    try:
        from repro_torch import trace
    except ImportError:  # a program without its own spans
        return None
    got = collect(run, kind, trace)
    print(table(kind, got), file=sys.stderr, flush=True)
    return got


def collect(run, kind: str, trace) -> dict:
    """``kind``'s work under ``trace.enabled()``: its spans and counters."""
    t = run.traffic
    batch = t.batch(0, warm=True)
    if kind == "prefill":
        def work():
            run.engine.prefill(batch)
        reps = int(run.cell.check.get("prefill_reps", 10))
        first = work
    elif kind == "generate":
        def work():
            run.engine.generate(batch, t.new).cpu()
        reps = int(run.cell.check.get("trace_calls", 1))

        def first():
            run.engine.generate(batch, min(t.new, 3)).cpu()  # a prefill, two decode steps
    else:
        raise ValueError(f"no traced work {kind!r}: 'prefill' or 'generate'")
    with trace.enabled():
        for _ in range(2):
            first()  # captures a step's two traced graphs
        trace.reset()
        for _ in range(reps):
            work()
        spans = trace.spans()
    return {"spans": spans, "counters": trace.snapshot()}


def table(kind: str, got: dict) -> str:
    """The spans (median, min and max ms over the steps, and the steps) and
    the counters, as lines of text."""
    lines = [f"program spans, traced {kind} (device ms a step):"]
    for name, ms in sorted(got["spans"].items()):
        lines.append(f"  {name:32s} median {statistics.median(ms):12.4f}  min {min(ms):12.4f}  "
                     f"max {max(ms):12.4f}  steps {len(ms)}")
    lines.append("program counters: " + " ".join(f"{k}={v!r}" for k, v in
                                                 sorted(got["counters"].items())))
    return "\n".join(lines)
