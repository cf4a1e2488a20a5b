#!/usr/bin/env python3
"""Time the RG-LRU scan kernel against an earlier version of its source, on
one CUDA card, in turns.

    python3 experiments/rglru_scan_ab.py --parent OLD/rglru_scan.cu \
        [--variants 2 4 8 ...] [--out build/rglru_ab.json]

``--parent`` is an earlier ``rglru_scan.cu`` with the one-thread-a-channel
entry point ``rglru_scan_fwd(x, r, i, log_lambda, y, st, dtype, lam_dtype,
B, S, W, c, stream)``; it is built with the same nvcc flags into the
git-ignored ``build/`` and loaded beside the package's kernel.  At
recurrentgemma-2b's prefill shape (bf16, B 8, S 1024, W 2560) both are
checked against the plain version (y at atol = rtol = 2e-2, the final
state at atol alone) and timed as chip_smoke.py times kernels (median of
10 by CUDA events behind a device spin), in the order earlier, new, new,
earlier.  Each variant (chunks a window) of the new kernel's
launch plan is checked and timed the same way at that shape and on
slow-decay inputs, and the ptxas report of both builds is printed.  The
last line of output is the JSON record, also written to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

SHAPE = smoke.RGEMMA_RGLRU
REPS = smoke.ML_REPS


def _parent(src: Path):
    """Build and load the earlier source; return its launcher and ptxas report."""
    from repro_torch.kernels import _build

    out = _build.build_dir() / "ab_parent_rglru_scan.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.flags("rglru_scan"), "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(out)).rglru_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, proc.stdout + proc.stderr


def main() -> int:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru_scan import _launch, rglru_plan, rglru_scan_plain

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--variants", nargs="*", default=[])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "rglru_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rglru_scan_ab: no CUDA device", file=sys.stderr)
        return 2
    card = smoke._card()
    print(f"[card] {card}", flush=True)
    device = torch.device("cuda", 0)
    parent, parent_log = _parent(args.parent)
    _build.load_library("rglru_scan")
    ptxas = {"parent": smoke._ptxas_summary(parent_log, "rglru_scan_kernel", None),
             "new": smoke._ptxas_summary(_build.build_log("rglru_scan"),
                                         "rglru_chunk_scan_kernel", None)}
    print("[ptxas] " + json.dumps(ptxas), flush=True)

    B, S, W = SHAPE
    inputs = {"normal": smoke._rglru_inputs(SHAPE, torch.bfloat16, device, 95),
              "slow": smoke._rglru_inputs(SHAPE, torch.bfloat16, device, 94, slow=True)}
    want = {k: rglru_scan_plain(*v, return_state=True) for k, v in inputs.items()}
    tol = smoke.ML_TOL["bfloat16"]

    def run_parent(x, r, i, lam):
        y = torch.empty_like(x)
        st = torch.empty((B, W), dtype=torch.float32, device=device)
        err = parent(x.data_ptr(), r.data_ptr(), i.data_ptr(), lam.data_ptr(), y.data_ptr(),
                     st.data_ptr(), 1, 0, B, S, W, 8.0,
                     torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"parent launch failed ({err})")
        return y, st

    def run_new(plan):
        def run(x, r, i, lam):
            y = torch.empty_like(x)
            st = torch.empty((B, W), dtype=torch.float32, device=device)
            _launch(x, r, i, lam, y, st, 8.0, plan)
            return y, st
        return run

    def measure(run) -> dict:
        rec = {}
        for name, a in inputs.items():
            got = run(*a)
            torch.cuda.synchronize()
            rec[f"err_{name}"] = smoke._scan_errs(got, want[name], tol, f"rglru {name}")
        rec["ms"] = smoke._events_ms(lambda: run(*inputs["normal"]), REPS)
        return rec

    default = rglru_plan(B, S, W, torch.bfloat16)
    turns = []
    for who in ("parent", "new", "new", "parent"):
        rec = measure(run_parent if who == "parent" else run_new(default))
        turns.append({"kernel": who, **rec})
        print(f"[turn] {who}: {rec['ms']:.4f} ms, errors {json.dumps(rec)}", flush=True)
    variants = []
    for spec in args.variants:
        plan = dataclasses.replace(default, n_chunks=int(spec))
        rec = {"n_chunks": plan.n_chunks, "window": plan.window,
               "grid": plan.grid, "threads": plan.threads, "smem": plan.smem,
               **measure(run_new(plan))}
        variants.append(rec)
        print(f"[variant] {spec}: {rec['ms']:.4f} ms", flush=True)
    plain_ms = smoke._events_ms(lambda: rglru_scan_plain(*inputs["normal"], return_state=True),
                                REPS)
    n_bytes = 2 * 4 * B * S * W + 4 * W + 4 * B * W
    out = {"card": card, "shape": {"B": B, "S": S, "W": W}, "dtype": "bfloat16",
           "default_plan": {"tile": default.tile, "chunk": default.chunk,
                            "n_chunks": default.n_chunks, "grid": default.grid,
                            "threads": default.threads},
           "turns": turns, "variants": variants, "plain_ms": plain_ms,
           **smoke._ml_bound(smoke.OPS_PER_RGLRU_STEP * B * S * W, n_bytes,
                             smoke.FP32_OPS_PER_S),
           "ptxas": ptxas}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
