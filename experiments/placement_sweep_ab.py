#!/usr/bin/env python3
"""Time the two placement-sweep kernels against earlier versions of their
sources, on one CUDA card, in turns.

    python3 experiments/placement_sweep_ab.py --parent OLD/ \
        [--out build/placement_sweep_ab.json]

``--parent`` is a directory holding an earlier ``placement_sweep.cu`` and
``placement_sweep_batch.cu`` with the one-thread-a-row entry points
``placement_sweep_f64(shares, iis, t_slr, t_cfg, resume_cost, repay_init,
B, n_t, n_f, feasible, placed, n_splits, devices_used, stream)`` and
``placement_sweep_batch_f64(shares, iis, t_slr, t_cfg, n_t_eff, n_f_eff,
resume_cost, repay_init, B, R, n_t, n_f, ..., stream)``; they are built
with the same nvcc flags into the git-ignored ``build/`` and loaded beside
the package's kernels (e.g. ``git show ccaa3ca:src/repro_torch/kernels/
csrc/placement_sweep.cu > build/parent/placement_sweep.cu``).

Shapes: kernel 1 at its table shape (10^6 rows x 8 tasks, 8 devices) and
at the deep instance's ramp blocks (64, 512, 4096, 32768 and 65536 rows x
10 tasks, 6 devices); kernel 2 at its table shape (64 instances x 4096
rows x 7 tasks, 4 devices), at ``schedule_many``'s ``block_size=16``
round (64 x 16) and at its ramp's first rounds (64 x 64, 64 x 512).  At
each, every kernel is first checked equal to the plain version
(``torch.equal``), then timed as chip_smoke.py times kernels (median of
30 by CUDA events behind a device spin) in the order parent, new, new,
parent, beside an empty kernel launched at the new plan's grid and block
(the launch floor) and the shape's bound.  Variants of the new plan are
timed too: the other path (``staged`` where the plan reads device memory
directly, ``direct`` where it stages), 8-byte copies into an odd stride
where the plan stages by 16 bytes (``vec8``), and blocks of 8 warps where
the plan spreads fewer a block (``8-warp-blocks``).  ptxas's report of every build
is printed.  The last line of output is the JSON record, also
written to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

REPS = smoke.TIMED_REPS
SINGLE_SHAPES = (  # rows, n_t, n_f
    (smoke.SWEEP_ROWS, 8, 8), (64, 10, 6), (512, 10, 6), (4096, 10, 6), (32768, 10, 6),
    (65536, 10, 6),
)
BATCH_SHAPES = (  # B, R, n_t, n_f
    (smoke.ROUND["B"], smoke.ROUND["R"], smoke.ROUND["n_t"], smoke.ROUND["n_f"]),
    (64, 16, 7, 4), (64, 64, 7, 4), (64, 512, 7, 4),
)
EMPTY_SRC = """
__global__ void empty_kernel() {}
extern "C" int empty_launch(int grid, int threads, void* stream) {
  empty_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""

_P = ctypes.c_void_p


def _nvcc(src: Path, name: str, flags_of: str):
    """Build ``src`` with the package's flags for ``flags_of``; return the
    library and ptxas's report."""
    from repro_torch.kernels import _build

    out = _build.build_dir() / f"ab_{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.flags(flags_of), "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr


def _fn(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = [*argtypes, _P]
    fn.restype = ctypes.c_int
    return fn


def _variants(plan) -> dict:
    """Other launches of the same tile walk: the other path (staged where
    the plan reads device memory directly, and the reverse), 8-byte copies
    into an odd stride
    where the plan stages by 16 bytes, and blocks of 8 warps where the plan
    spreads fewer a block over more SMs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import placement_step as ps

    out = {}
    stride = plan.n_t | 1
    doubles = ps._staged(plan.B, plan.R, plan.n_t, plan.n_f, stride)[1]
    if not plan.direct:
        out["direct"] = dataclasses.replace(plan, direct=True, stride=0, buffer_doubles=0)
        if plan.vec == 16:
            out["vec8"] = dataclasses.replace(plan, vec=8, stride=stride, buffer_doubles=doubles)
        if plan.warps < 8:
            out["8-warp-blocks"] = dataclasses.replace(plan, warps=8, grid=-(-plan.tiles // 8))
    else:
        if 8 * plan.warps * doubles <= _build.MAX_SMEM:
            out["staged"] = dataclasses.replace(plan, direct=False, stride=stride, vec=8,
                                                buffer_doubles=doubles)
    return out


def main() -> int:
    import torch

    from repro_torch.core import FleetSpec
    from repro_torch.kernels import _build
    from repro_torch.kernels import placement_step as ps

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "placement_sweep_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("placement_sweep_ab: no CUDA device", file=sys.stderr)
        return 2
    card = smoke._card()
    print(f"[card] {card}", flush=True)
    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    stream = lambda: torch.cuda.current_stream(device).cuda_stream  # noqa: E731

    p1, log1 = _nvcc(args.parent / "placement_sweep.cu", "parent_placement_sweep",
                     "placement_sweep")
    p2, log2 = _nvcc(args.parent / "placement_sweep_batch.cu", "parent_placement_sweep_batch",
                     "placement_sweep_batch")
    empty_src = _build.build_dir() / "ab_empty.cu"
    empty_src.write_text(EMPTY_SRC)
    empty_lib, _ = _nvcc(empty_src, "empty", "empty")
    parent1 = _fn(p1, "placement_sweep_f64", ps._SWEEP_ARGTYPES[:13])
    parent2 = _fn(p2, "placement_sweep_batch_f64", ps._BATCH_ARGTYPES[:16])
    empty = _fn(empty_lib, "empty_launch", [ctypes.c_int, ctypes.c_int])
    for name in ("placement_sweep", "placement_sweep_batch"):
        _build.load_library(name)
    ptxas = {
        "parent_placement_sweep": smoke._ptxas_summary(log1, "placement_sweep_kernel"),
        "parent_placement_sweep_batch": smoke._ptxas_summary(log2, "placement_sweep_batch_kernel"),
        "placement_sweep": smoke._ptxas_summary(_build.build_log("placement_sweep"),
                                                "placement_sweep_kernel", None),
        "placement_sweep_batch": smoke._ptxas_summary(
            _build.build_log("placement_sweep_batch"), "placement_sweep_batch_kernel", None),
    }
    print("[ptxas] " + json.dumps(ptxas), flush=True)

    def outs(shape):
        return (torch.empty(shape, dtype=torch.bool, device=device),
                *(torch.empty(shape, dtype=torch.int32, device=device) for _ in range(3)))

    def ptrs(ts):
        return [t.data_ptr() for t in ts]

    call = dict(resume_cost=0.0, repay_init=True)
    rng = np.random.default_rng(18)
    records = []

    def measure(kernel, shape, runs, plan, want, n_bytes, steps):
        """Check each run == plain, then time them in turns with the floor."""
        errs = {}
        for who, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            errs[who] = all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
            if not errs[who]:
                raise AssertionError(f"{kernel} {shape} {who}: differs from the plain version")
        turns = []
        for who in ("parent", "new", "new", "parent"):
            turns.append({"kernel": who, "ms": smoke._events_ms(runs[who], REPS)})
        variants = {who: smoke._events_ms(run, REPS) for who, run in runs.items()
                    if who not in ("parent", "new")}
        floor = smoke._events_ms(lambda: empty(plan.grid, plan.threads, stream()), REPS)
        rec = {"kernel": kernel, "shape": shape, "plan": dataclasses.asdict(plan),
               "path": plan.path, "smem": plan.smem, "turns": turns, "variants": variants,
               "empty_launch_ms": floor, "bytes": n_bytes, "row_steps": steps,
               **smoke._bound(n_bytes, steps)}
        new = [t["ms"] for t in turns if t["kernel"] == "new"]
        old = [t["ms"] for t in turns if t["kernel"] == "parent"]
        rec["parent_over_new"] = min(old) / max(new)
        print(f"[ab] {kernel} {shape}: parent {old}, new {new}, variants {variants}, "
              f"floor {floor:.4f}, bound {rec['bound_ms']:.4f} ms", flush=True)
        records.append(rec)

    for rows, n_t, n_f in SINGLE_SHAPES:
        fleet = FleetSpec(n_f=n_f, t_slr=80.0 if n_t == 8 else 100.0,
                          t_cfg=4.0 if n_t == 8 else 0.0)
        on = dict(dtype=torch.float64, device=device)
        shares = torch.tensor(smoke.sweep_block(rng, rows, n_t, fleet.capacity), **on)
        iis = torch.tensor(rng.uniform(1.0, 5.0, n_t), **on)
        slr, cfg = torch.tensor(fleet.t_slr_arr, **on), torch.tensor(fleet.t_cfg_arr, **on)
        head = [shares.data_ptr(), iis.data_ptr(), slr.data_ptr(), cfg.data_ptr(), 0.0, 1,
                rows, n_t, n_f]
        plan = ps.sweep_plan(1, rows, n_t, n_f, sm_count=sms)

        def run_plan(p, head=head, rows=rows):
            def run():
                o = outs(rows)
                _build.launch("placement_sweep", "placement_sweep_f64", ps._SWEEP_ARGTYPES,
                              (*head, *ptrs(o), *p.args()), device)
                return o
            return run

        def run_parent(head=head, rows=rows):
            o = outs(rows)
            if parent1(*head, *ptrs(o), stream()):
                raise RuntimeError("parent launch failed")
            return o

        runs = {"parent": run_parent, "new": run_plan(plan)}
        runs.update({k: run_plan(v) for k, v in _variants(plan).items()})
        steps = ps._plain_sweep(shares, iis, slr, cfg, 0.0, True)[1]
        want = ps.placement_sweep_plain(shares, iis, slr, cfg, **call)
        n_bytes = 8 * rows * n_t + 8 * (n_t + 2 * n_f) + 13 * rows
        measure("placement_sweep", [rows, n_t, n_f], runs, plan, want, n_bytes, steps)

    for B, R, n_t, n_f in BATCH_SHAPES:
        tables = smoke.instance_stack(rng, [(R, n_t, n_f)] * B, device)[0]
        head = [*ptrs(tables), 0.0, 1, B, R, n_t, n_f]
        plan = ps.sweep_plan(B, R, n_t, n_f, sm_count=sms)

        def run_plan(p, head=head, shape=(B, R)):
            def run():
                o = outs(shape)
                _build.launch("placement_sweep_batch", "placement_sweep_batch_f64",
                              ps._BATCH_ARGTYPES, (*head, *ptrs(o), *p.args()), device)
                return o
            return run

        def run_parent(head=head, shape=(B, R)):
            o = outs(shape)
            if parent2(*head, *ptrs(o), stream()):
                raise RuntimeError("parent launch failed")
            return o

        runs = {"parent": run_parent, "new": run_plan(plan)}
        runs.update({k: run_plan(v) for k, v in _variants(plan).items()})
        steps = ps._plain_sweep_batch(*tables, 0.0, True)[1]
        want = ps.placement_sweep_batch_plain(*tables, **call)
        n_bytes = 8 * B * R * n_t + 8 * B * (n_t + 2 * n_f) + 8 * B + 13 * B * R
        measure("placement_sweep_batch", [B, R, n_t, n_f], runs, plan, want, n_bytes, steps)

    out = {"card": card, "sm_count": sms, "reps": REPS, "records": records, "ptxas": ptxas}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
