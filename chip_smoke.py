#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the PADPS-FR scheduler on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

1. build every CUDA kernel of the main path from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together) and print the card's name
   and power limit;
2. hold each kernel against its plain torch version on the card, at the
   main path's shapes and at ragged sizes, and time both with CUDA events;
3. the main path, through ``PADPSFRScheduler(engine="cuda").schedule``:
   the paper's Example 1 (|TSS|=1024 |TFS|=620 rejects=146 rank=4
   power=31.5, T3 split 12:12);
4. the deep 10-task x 4-variant instance on 6 devices (winner at rank
   425399), checked against the plain engine on CPU tensors;
5. the placement options (``resilience=1``; the preemptive resume cost),
   checked against the plain engine on CPU tensors.

The launch counts are zeroed just before each main-path phase and read
just after it; the comparisons of phase 2 are outside those windows.  The
last three lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Exits non-zero without
printing a result when no CUDA device is present or when run outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float64 (non-tensor-core)
# peak, the rate the placement sweep's scalar float64 chain runs at.
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
# float64 adds/subtracts/compares per sweep step, counted from the kernel:
# c-tcfg, -extra, tcfg+ii, +eps, c>gate, avail>eps, share-tsd, tsd>eps,
# rem-avail, >eps, avail-rem, <=gate.
OPS_PER_STEP = 12

SWEEP_ROWS = 1_000_000
RAGGED_ROWS = (1, 7, 1025)
TIMED_REPS = 30
EXAMPLE1 = dict(n_tss=1024, n_tfs=620, rejects=146, rank=4, power=31.5)
DEEP_RANK = 425399


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# instances (copied from the JAX package's benchmarks/scheduler_scale.py)
# ---------------------------------------------------------------------------


def band_tasks(n_t, nv, seed=7, base=86.0, slope=5.0, noise=1.0, ii=(8.0, 16.0)):
    """Tasks whose shares fall near-affinely with power: the power-sorted
    TFS opens with a long band of rows that pass eq. 7 but fail placement,
    so the winner lands 1e5+ rows deep."""
    from repro_torch.core import Task, TaskVariant

    rng = np.random.default_rng(seed)
    tasks = []
    for i in range(n_t):
        pws = np.sort(rng.uniform(3.0, 9.0, nv))
        shr = np.maximum(base - slope * pws + rng.uniform(0, noise, nv), 0.5)
        period, data, t_slr = 50.0, 1.0, 100.0
        ths = data * t_slr / (period * shr)
        tasks.append(
            Task(
                name=f"B{i}",
                period=period,
                data=data,
                init_interval=float(rng.uniform(*ii)),
                variants=tuple(
                    TaskVariant(cu=j + 1, throughput=float(t), power=float(p))
                    for j, (t, p) in enumerate(zip(ths, pws, strict=True))
                ),
            )
        )
    return tasks


def deep_instance():
    """The deep streaming instance: 10 tasks x 4 variants on 6 devices."""
    from repro_torch.core import FleetSpec

    return band_tasks(10, 4, base=86.0), FleetSpec(n_f=6, t_slr=100.0, t_cfg=0.0)


def sweep_block(rng, B, n_t, capacity):
    """A block of rows spread around the fleet capacity (mixed verdicts)."""
    base = rng.uniform(0.5, 1.5, (B, n_t))
    scale = rng.uniform(0.4, 1.3, (B, 1)) * capacity / n_t
    return base * scale


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build() -> dict:
    from repro_torch.kernels import _build

    sources = sorted(p.stem for p in (ROOT / "src/repro_torch/kernels/csrc").glob("*.cu"))
    t0 = time.perf_counter()
    # One nvcc per source, all at once: each build is a separate process.
    procs = [
        subprocess.Popen([sys.executable, "-c", f"from repro_torch.kernels import _build; "
                          f"_build.load_library({name!r})"], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        for name in sources
    ]
    codes = [p.wait(timeout=600) for p in procs]
    if any(codes):
        raise RuntimeError(f"kernel builds failed: {dict(zip(sources, codes, strict=True))}")
    for name in sources:
        _build.load_library(name)
    secs = time.perf_counter() - t0
    print(f"[build] {sources} in {secs:.2f} s -> {_build.build_dir()}", flush=True)
    return {"sources": sources, "seconds": secs}


def _events_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernel_vs_plain(device) -> dict:
    """placement_sweep: kernel == plain version on the card, then timed."""
    import torch

    from repro_torch.core import FleetSpec
    from repro_torch.core.placement_backends import survivor_tables
    from repro_torch.kernels.placement_step import (
        _plain_sweep,
        placement_sweep_cuda,
        placement_sweep_plain,
    )

    n_t = n_f = 8
    fleet = FleetSpec(n_f=n_f, t_slr=80.0, t_cfg=4.0)
    rng = np.random.default_rng(3)
    iis_np = rng.uniform(1.0, 5.0, n_t)
    on = dict(dtype=torch.float64, device=device)
    iis = torch.tensor(iis_np, **on)
    slr = torch.tensor(fleet.t_slr_arr, **on)
    cfg = torch.tensor(fleet.t_cfg_arr, **on)
    slr_s, cfg_s = (torch.tensor(a, **on) for a in survivor_tables(fleet.t_slr_arr, fleet.t_cfg_arr, 1))
    variants = [
        ("padpsfr", slr, cfg, dict(repay_init=True, resume_cost=0.0)),
        ("padpsfr-resume9.5", slr, cfg, dict(repay_init=True, resume_cost=9.5)),
        ("preemptive-resume0", slr, cfg, dict(repay_init=False, resume_cost=0.0)),
        ("preemptive-resume9.5", slr, cfg, dict(repay_init=False, resume_cost=9.5)),
        ("survivors-k1", slr_s, cfg_s, dict(repay_init=True, resume_cost=0.0)),
    ]
    max_err = 0
    big = None
    for B in (*RAGGED_ROWS, SWEEP_ROWS):
        shares = torch.tensor(sweep_block(rng, B, n_t, fleet.capacity), **on)
        for name, s_tab, c_tab, kw in variants:
            got = placement_sweep_cuda(shares, iis, s_tab, c_tab, **kw)
            want = placement_sweep_plain(shares, iis, s_tab, c_tab, **kw)
            torch.cuda.synchronize()
            for g, w, out in zip(got, want, ("feasible", "placed", "n_splits", "devices_used"),
                                 strict=True):
                if not torch.equal(g, w):
                    raise AssertionError(f"placement_sweep {name} B={B}: {out} differs")
                max_err = max(max_err, int((g.long() - w.long()).abs().max()))
        n_feas = int(got[0].sum())
        print(f"[kernel] placement_sweep B={B}: 5 variants equal to plain "
              f"(last: {n_feas}/{B} feasible)", flush=True)
        if B == SWEEP_ROWS:
            big = shares
    assert big is not None
    call = dict(repay_init=True, resume_cost=0.0)
    ms = _events_ms(lambda: placement_sweep_cuda(big, iis, slr, cfg, **call), TIMED_REPS)
    plain_ms = _events_ms(lambda: placement_sweep_plain(big, iis, slr, cfg, **call), TIMED_REPS)
    (feas, *_), steps = _plain_sweep(big, iis, slr, cfg, call["resume_cost"], call["repay_init"])
    n_bytes = 8 * SWEEP_ROWS * n_t + 8 * (n_t + 2 * n_f) + SWEEP_ROWS * (1 + 4 + 4 + 4)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = steps * OPS_PER_STEP / FP64_OPS_PER_S * 1e3
    rec = {
        "rows": SWEEP_ROWS, "n_t": n_t, "n_f": n_f, "feasible_rows": int(feas.sum()),
        "row_steps": steps, "bytes": n_bytes, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "max_abs_err": max_err, "library_ms": None,
    }
    print("[kernel] " + json.dumps({"placement_sweep_timing": rec}), flush=True)
    return rec


def _same_result(a, b, what: str) -> None:
    """Two ScheduleResults agree field for field (exact)."""
    fields = ("feasible", "chosen_rank", "n_placement_rejects", "total_power",
              "n_tss", "n_tfs", "n_tnfs")
    for f in fields:
        if getattr(a, f) != getattr(b, f):
            raise AssertionError(f"{what}: {f} {getattr(a, f)} != {getattr(b, f)}")
    if a.feasible:
        if a.combo != b.combo:
            raise AssertionError(f"{what}: combo {a.combo} != {b.combo}")
        sa = [(s.task, s.devices, s.share_parts) for s in a.plan.splits]
        sb = [(s.task, s.devices, s.share_parts) for s in b.plan.splits]
        if sa != sb:
            raise AssertionError(f"{what}: splits {sa} != {sb}")
        ga = [[(g.kind, g.task, g.start, g.end) for g in s.segments] for s in a.plan.scripts]
        gb = [[(g.kind, g.task, g.start, g.end) for g in s.segments] for s in b.plan.scripts]
        if ga != gb:
            raise AssertionError(f"{what}: plan segments differ")


def phase_example1(engine: str) -> None:
    from repro_torch.configs.paper_examples import example1_fleet, example1_tasks
    from repro_torch.core import PADPSFRScheduler, render_gantt

    tasks, fleet = example1_tasks(), example1_fleet()
    res = PADPSFRScheduler(fleet, engine=engine).schedule(tasks, count_all_rejects=True)
    got = dict(n_tss=res.n_tss, n_tfs=res.n_tfs, rejects=res.n_placement_rejects,
               rank=res.chosen_rank, power=res.total_power)
    if got != EXAMPLE1:
        raise AssertionError(f"Example 1: {got} != {EXAMPLE1}")
    sp = res.plan.splits
    if not (len(sp) == 1 and sp[0].task == 2 and sp[0].devices == (1, 2)
            and [round(p) for p in sp[0].share_parts] == [12, 12]):
        raise AssertionError(f"Example 1: T3 split is {sp}")
    print(f"[example1] {res.summary(tasks)}")
    print(render_gantt(res.plan, tasks, fleet), flush=True)


def phase_deep(engine: str) -> dict:
    from repro_torch.core import PADPSFRScheduler, WalkStats

    tasks, fleet = deep_instance()
    runs = []
    for _ in range(2):  # the first run pays one-time set-up (pinned pool, module load)
        ws = WalkStats()
        t0 = time.perf_counter()
        res = PADPSFRScheduler(fleet, engine=engine, exhaustive=False).schedule(
            tasks, walk_stats=ws
        )
        runs.append((time.perf_counter() - t0, ws, res))
    if res.chosen_rank != DEEP_RANK:
        raise AssertionError(f"deep instance: rank {res.chosen_rank} != {DEEP_RANK}")
    _same_result(runs[0][2], res, "deep instance, first run vs second")
    t0 = time.perf_counter()
    ref = PADPSFRScheduler(fleet, engine="torch", exhaustive=False).schedule(tasks)
    plain_s = time.perf_counter() - t0
    _same_result(res, ref, "deep instance cuda vs torch")
    rec = {
        "instance": "10t4v_nf6", "rank": res.chosen_rank,
        "rejects": res.n_placement_rejects, "combo": list(res.combo.variant_idx),
        "schedule_s": [r[0] for r in runs], "walk_stats": [r[1].as_dict() for r in runs],
        "torch_cpu_schedule_s": plain_s,
        "device_us": _device_split(lambda: PADPSFRScheduler(
            fleet, engine=engine, exhaustive=False).schedule(tasks)),
    }
    print("[deep] " + json.dumps(rec), flush=True)
    return rec


def _device_split(run) -> dict:
    """Device time of one traced ``run()`` by kind, from torch.profiler:
    the sweep kernel, host-to-device and device-to-host copies, the rest."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    split = {"placement_sweep_kernel": 0.0, "memcpy_htod": 0.0, "memcpy_dtoh": 0.0}
    other: dict[str, float] = {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        if us <= 0.0:
            continue
        if "placement_sweep_kernel" in e.key:
            split["placement_sweep_kernel"] += us
        elif "HtoD" in e.key:
            split["memcpy_htod"] += us
        elif "DtoH" in e.key:
            split["memcpy_dtoh"] += us
        else:
            other[e.key] = other.get(e.key, 0.0) + us
    if not any(split.values()) and not other:
        return {"device_us": "not measured (the profiler recorded no device time)"}
    busy = sum(split.values()) + sum(other.values())
    split["other"] = dict(sorted(other.items(), key=lambda kv: -kv[1])[:6])
    # Device events may overlap one another, so this busy share is an upper bound.
    split["traced_wall_us"] = wall_us
    split["device_busy_share"] = busy / wall_us
    return split


def phase_options(engine: str) -> None:
    from repro_torch.configs.paper_examples import example1_fleet, example1_tasks
    from repro_torch.core import PADPSFRScheduler

    tasks, fleet = example1_tasks(), example1_fleet()
    for kw in (dict(resilience=1), dict(repay_init=False, t_capture=4.5, t_store=5.0)):
        got = PADPSFRScheduler(fleet, engine=engine).schedule(tasks, count_all_rejects=True, **kw)
        want = PADPSFRScheduler(fleet, engine="torch").schedule(tasks, count_all_rejects=True, **kw)
        _same_result(got, want, f"Example 1 {kw}")
        print(f"[options] {kw}: {got.summary()}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    from repro_torch.kernels.placement_step import placement_sweep_cuda

    card = _card()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    phase_build()
    timing = phase_kernel_vs_plain(torch.device("cuda", 0))

    launches = {}
    for name, run in (
        ("example1", lambda: phase_example1("cuda")),
        ("deep", lambda: phase_deep("cuda")),
        ("options", lambda: phase_options("cuda")),
    ):
        placement_sweep_cuda.launches = 0
        run()
        launches[name] = placement_sweep_cuda.launches
        if launches[name] <= 0:
            raise AssertionError(f"main path '{name}' launched placement_sweep {launches[name]} times")
    print(f"[launches] placement_sweep per main-path phase: {json.dumps(launches)}", flush=True)

    kernels = [{
        "name": "placement_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/placement_sweep.cu",
        "replaces": "src/repro/kernels/placement_step.py:136",
        "launches": sum(launches.values()),
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
