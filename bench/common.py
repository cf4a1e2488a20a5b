"""What every part of the benchmark shares: finding a cell's files by name,
seeds derived from ``--seed``, the card's published peaks, and the reduction
of a profiler trace to busy time, top device operations and idle gaps.

Imports neither the program under test nor JAX: the reference and the
arithmetic import this module too.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent

# Streams of the seed: each use of ``--seed`` draws from its own.
WEIGHTS, BATCH, SAMPLE, WARM = 0, 1, 2, 3


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream ``path`` of ``seed`` (any whole number)."""
    import numpy as np

    entropy = [int(seed) % (1 << 64), *(int(p) for p in path)]
    return int(np.random.default_rng(entropy).integers(1 << 63))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The Python file at ``path`` as a module (a metric's reader, a runner, a
    reference or a count), loaded by its path: its name may hold dots."""
    path = Path(path).resolve()
    rel = path.relative_to(BENCH) if path.is_relative_to(BENCH) else path
    name = "bench_" + re.sub(r"\W", "_", str(rel))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with the files its names point to: the
    configuration, the traffic mix, the cell's own check settings
    (``cells/<name>.json``) and the metrics that it reports."""

    def __init__(self, root: Path, name: str) -> None:
        self.root = root
        self.dir = root / "bench"
        self.bench = load_json(root / "BENCHMARK.json")
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            known = ", ".join(w["name"] for w in self.bench["workloads"])
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")
        self.workload = found[0]
        self.name = name
        entry = [c for c in self.bench["configs"] if c["name"] == self.workload["config"]][0]
        self.config = load_json(root / entry["file"])
        self.traffic = load_json(self.dir / "traffic" / f"{self.workload['traffic']}.json")
        self.check = load_json(self.dir / "cells" / f"{name}.json")
        self.chips = int(self.workload["chips"])

    def metrics(self, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports:
        those whose ``workloads`` name it, or that have none and move an
        end-to-end metric this cell reports."""
        mine = {m["name"] for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])}
        out = []
        for m in self.bench[kind]:
            if "workloads" in m:
                if self.name in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or m.get("moves") in mine:
                out.append(m)
        return out

    def module(self, kind: str, name: str):
        return load_module(self.dir / kind / f"{name}.py")


def peaks(device_name: str) -> dict | None:
    """The card's published dense peaks (``peaks.json``), by its name."""
    for key, row in load_json(BENCH / "peaks.json")["cards"].items():
        if key in device_name:
            return row
    return None


def quantile(values: list[float], q: float) -> float:
    """The q-th quantile (0 < q < 1) of ``values``, linearly between order
    statistics (``statistics.quantiles``' inclusive method)."""
    import numpy as np

    return float(np.percentile(values, 100 * q))


# ---------------------------------------------------------------------------
# Profiler traces, reduced in memory
# ---------------------------------------------------------------------------


def trace_events(prof) -> tuple[list, list]:
    """(device events, host events) of a finished ``torch.profiler.profile``,
    each as (name, start ns, end ns): the device's kernels, copies and sets,
    and the host's operations and runtime calls."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        row = (e.name(), start, start + e.duration_ns())
        if e.device_type() != DeviceType.CUDA:
            host.append(row)
        elif not e.is_user_annotation():  # a host range drawn on the device's timeline
            dev.append(row)
    return dev, host


def merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_trace(dev: list, host: list, t0: int, t1: int, top: int = 10) -> dict:
    """The device's busy seconds inside the window [t0, t1] (ns; the union
    of its events' intervals, clipped), the window's seconds, the ``top``
    device operations by their summed seconds, and the ``top`` longest idle
    gaps, each named by the innermost host event running at its start."""
    inside = [(n, max(a, t0), min(b, t1)) for n, a, b in dev if b > t0 and a < t1]
    busy = merge([(a, b) for _, a, b in inside])
    by_name: dict[str, int] = {}
    for n, a, b in inside:
        by_name[n] = by_name.get(n, 0) + (b - a)
    gaps = []
    edge = t0
    for a, b in busy + [(t1, t1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    host_in = sorted((b - a, n, a, b) for n, a, b in host if b > t0 and a < t1)

    def doing(at: int) -> str:
        for _, n, a, b in host_in:  # shortest first: the innermost
            if a <= at < b:
                return n
        return "no host operation (Python)"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-9,
        "window_s": (t1 - t0) * 1e-9,
        "device_ops": [[_short(n), ns * 1e-9] for n, ns in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[_short(doing(a)), (b - a) * 1e-9] for a, b in longest],
    }


def _short(name: str, n: int = 160) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."
