"""A serving or training step captured as CUDA graphs: the port's counterpart of
``jax.jit``.

``CudaGraphStep(fn, device, pool=, donate=, spans=)`` wraps a step ``fn(*args)``
whose arguments and results are tensors in nested dicts, tuples, lists and
dataclasses (``None`` an empty subtree, as in ``_tree``).
Like ``jax.jit``, which compiles a program for each abstract signature, it
keeps one ``torch.cuda.CUDAGraph`` for each signature of its arguments
(the tree's structure and each tensor's shape, dtype and device):

* the first call of a signature runs ``fn`` eagerly on a side stream (the
  warm-up, whose results this call returns: it fills lazy state such as
  cuBLAS's handles and workspaces and builds the kernels, so that nothing
  of the kind is allocated inside a capture), then captures ``fn`` on that
  stream into a graph over static inputs: the arguments in ``donate``
  themselves, clones of the rest;
* a later call copies each argument that is not already its static input
  into it (a donated one passed back, as a decode step's state, is not
  copied) and replays the graph on the current stream, with no host sync.

The results of a replay are the graph's own output tensors: they hold
until the next replay of any graph in the same memory pool (the serving
engine's prefill and decode graphs share one), so the caller consumes or
copies them before that.  A donated argument is updated in place, as
``jax.jit``'s ``donate_argnums`` lets XLA reuse its buffer.

The kernels' launch counts (``kernels.counts``) count the launches their
wrappers make, and a replay runs no wrapper: the capture's additions are
taken back (a capture records kernels and launches none).  What a replay
launches is read from the graph itself: ``kernels(key)`` names its kernel
nodes as the CUDA runtime prints them (``cudaGraphDebugDotPrint``), which
every replay launches once each, and ``launches(key)`` the wrappers'
launches they stand for (``kernels.counts.seen``); ``replayed`` tallies
them over the replays made.

A step whose ``fn`` holds device spans (``spans=True``: the serving
engine's steps of the transformer families) is traced.  With tracing on
(``trace.enabled()``) its signature is captured again, as
two graphs of its own in the same pool, replayed in turns: the spans
inside ``fn`` become each graph's timing-event nodes (``trace.capturing``),
and each replay hands them to ``trace.replayed``.  A graph's events are
read just before it replays again, so the host waits for the replay
before last, never for the one it just launched, and the card does not
stand still for the reading.  A capture of a signature already captured
(untraced, or the first of the two) runs no second eager warm-up (the
lazy state is filled, and a warm-up's temporaries would lie outside the
pool); it reuses that graph's static inputs, and this call's result is
the new graph's first replay.  The untraced graphs stay as they are, for
when tracing goes off again.  Any other step keeps one graph a signature,
with tracing on or off, and a span inside its capture times nothing.  The
host's time is named by ``graph.capture`` and ``graph.replay`` ranges.

There is no fallback: a warm-up, capture or replay that fails raises (a
host read inside ``fn``, such as ``.item()``, makes the capture fail), and
nothing is retried eagerly.  A capture that fails leaves no allocation
routed into the step's pool: the step ends the routing, which
``torch.cuda.graph`` leaves open when the capture was invalidated (its
``capture_end`` raises first), and while it is open the caching
allocator gives no cached block back to the device.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import re
import tempfile
import time
import warnings
from typing import Any, Callable

import torch

from . import trace
from ._tree import leaves, unflatten
from .kernels import counts

__all__ = ["CudaGraphStep", "kernel_nodes", "signature"]


def signature(tree: Any) -> tuple | None:
    """The hashable abstract signature of a tree of tensors: its structure
    and each tensor's shape, dtype and device."""
    if tree is None:  # an empty subtree, as in ``_tree``
        return None
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return ("dict", tuple((k, signature(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(signature(t) for t in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree).__name__, tuple((f.name, signature(getattr(tree, f.name)))
                                           for f in dataclasses.fields(tree)))
    raise TypeError(f"a captured step takes tensors in dicts, tuples, lists and dataclasses; "
                    f"got {type(tree).__name__}")


def kernel_nodes(dot: str) -> list[str]:
    """The kernel nodes of a graph that ``cudaGraphDebugDotPrint`` printed
    as ``dot``: for each, the line that names it (its ID, then its mangled
    name and launch shape); the other nodes (copies, sets) left out."""
    return [m.group(1) for m in re.finditer(r'label="\{\s*KERNEL\s*\n(\| \{ID \|[^\n]*)', dot)]


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: list  # the static input tensors, in leaf order
    outputs: Any  # the static output tree
    replays: int = 0
    launches: dict | None = None  # one replay's, read from the graph on first use
    events: list = dataclasses.field(default_factory=list)  # the spans' (``trace.capturing``)


def _end_allocating_to(pool) -> None:
    """End the current device's allocations into ``pool`` after a capture
    that raised; nothing when ``capture_end`` had ended them."""
    try:
        torch._C._cuda_endAllocateToPool(torch.cuda.current_device(), pool)
    except RuntimeError:
        pass  # "not currently recording to" the pool: already ended


class CudaGraphStep:
    """``fn`` captured as a CUDA graph per argument signature (see the
    module's docstring).  ``graphs`` holds the captures by signature (the
    traced ones' keys ``(signature, "traced", 0 or 1)``), ``captures`` a
    record of each (its key and the ms of its first call: warm-up and
    capture), which ``trace.snapshot`` reads."""

    def __init__(self, fn: Callable, device: torch.device, *, pool=None,
                 donate: tuple[int, ...] = (), spans: bool = False) -> None:
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph captures work on a CUDA device, not {device}")
        self.fn = fn
        self.device = device
        self.pool = pool if pool is not None else torch.cuda.graph_pool_handle()
        self.donate = frozenset(donate)
        self.spans = spans
        self.graphs: dict[tuple, _Graph] = {}
        self.captures: list[dict] = []
        self._stream = torch.cuda.Stream(device)
        self._turns: dict[tuple, int] = {}  # traced calls by signature
        trace.watch(self)

    def __call__(self, *args: Any) -> Any:
        key = sig = signature(args)
        if self.spans and trace.is_on():
            turn = self._turns[sig] = self._turns.get(sig, -1) + 1
            key = (sig, "traced", turn % 2)
        entry = self.graphs.get(key)
        if entry is None:
            base = next((self.graphs[k] for k in (sig, (sig, "traced", 0)) if k in self.graphs),
                        None)
            with trace.span("graph.capture", outer=True):
                return self._capture(key, args, base)
        with trace.span("graph.replay", outer=True):
            self._replay(entry, args)
        return entry.outputs

    def _replay(self, entry: _Graph, args: tuple) -> None:
        for static, leaf in zip(entry.inputs, leaves(args), strict=True):
            if static is not leaf:
                static.copy_(leaf)
        if entry.events:
            trace.flush(entry.events)  # its last replay's, before this one records over them
        entry.graph.replay()
        entry.replays += 1
        trace.replayed(entry.events)

    def kernels(self, key: tuple) -> list[str]:
        """The kernel nodes of the graph captured for signature ``key``,
        each launched once by every replay, named as the CUDA runtime
        prints them (``kernel_nodes``)."""
        with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
            warnings.simplefilter("ignore")  # debug_dump announces itself
            path = os.path.join(tmp, "graph.dot")
            self.graphs[key].graph.debug_dump(path)
            with open(path) as f:
                return kernel_nodes(f.read())

    def launches(self, key: tuple) -> dict[str, int]:
        """The wrappers' launches one replay of ``key``'s graph makes, by
        ``kernels.counts``' names: its kernel nodes' (``counts.seen``)."""
        entry = self.graphs[key]
        if entry.launches is None:
            entry.launches = counts.seen(self.kernels(key))
        return entry.launches

    @property
    def replayed(self) -> dict[str, int]:
        """The wrappers' launches of every replay so far: each graph's
        ``launches`` times its replays."""
        out: dict[str, int] = {}
        for key, entry in self.graphs.items():
            if entry.replays:
                for name, n in self.launches(key).items():
                    out[name] = out.get(name, 0) + n * entry.replays
        return out

    def _capture(self, key: tuple, args: tuple, base: _Graph | None) -> Any:
        """Warm up and capture ``key``'s graph; with a graph of the same
        signature already captured (``base``), capture alone over its
        static inputs, then replay."""
        t0 = time.perf_counter()
        warm = base is None
        if warm:
            static = [leaf for i, arg in enumerate(args)
                      for leaf in (leaves(arg) if i in self.donate else
                                   [t.clone() for t in leaves(arg)])]
        else:
            static = base.inputs  # this call's arguments go in at the replay
        static_args = unflatten(args, static)
        events: list = []
        with torch.cuda.device(self.device):
            cur = torch.cuda.current_stream()
            self._stream.wait_stream(cur)
            if warm:
                with torch.cuda.stream(self._stream):
                    out = self.fn(*args)  # the warm-up: this call's result
                cur.wait_stream(self._stream)
            graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept for ``kernels``
            graph.enable_debug_mode()
            before = counts.read()
            # A graph freed while another is captured (an unreachable engine
            # collected by Python's cycle collector) invalidates the capture:
            # collect now, and not again until the capture ends.
            gc_on = gc.isenabled()
            gc.collect()
            gc.disable()
            try:
                # torch.cuda.graph synchronises and releases the warm-up's
                # cached blocks before it begins
                with trace.capturing(events if self.spans else None), torch.cuda.graph(
                        graph, pool=self.pool, stream=self._stream):
                    static_out = self.fn(*static_args)
            except BaseException:
                _end_allocating_to(self.pool)
                raise
            finally:
                if gc_on:
                    gc.enable()
                counts.add({name: -n for name, n in counts.delta(counts.read(), before).items()})
            graph.instantiate()
            torch.cuda.synchronize()
        entry = self.graphs[key] = _Graph(graph, static, static_out, events=events)
        if not warm:
            self._replay(entry, args)
            out = static_out
        self.captures.append({"signature": key, "ms": (time.perf_counter() - t0) * 1e3})
        return out
