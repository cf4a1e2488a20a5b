"""Run one cell of the benchmark of the PyTorch and CUDA port on this
machine's cards, and print its result as the last line of standard output.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell; its
configuration, traffic mix, check settings (``bench/cells/<cell>.json``),
runner, reference, counts and metric readers are files found by name.
With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer ones (and the device's busy time, the
traced window and a breakdown). Either way the run checks what its window
served against the plain reference and prints each number compared beside
its limit, last on standard error and last in the result.

It exits with 2 and prints no result without CUDA, with fewer cards than
the cell asks for, or without the program (``src/repro_torch``) beside it;
with 3 if JAX or the JAX package was loaded by the time the window closed.
Build caches stay inside the checkout, at fixed paths under ``build/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# compared by whole top-level module name: the port, repro_torch, is allowed
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_loaded() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def execute(cell, *, seed: int, seconds: float, trace: bool, device: str,
            t_start: float) -> tuple[dict, dict]:
    """One run of ``cell`` on ``device``: the result object (``checked``
    last) and notes for standard error."""
    import torch

    runner = cell.module("runners", cell.traffic["runner"])
    out = runner.run(cell, seed=seed, seconds=seconds, trace=trace, device=device,
                     t_start=t_start, per_layer=cell.metrics("per_layer"),
                     end_to_end=cell.metrics("end_to_end"))
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"],
           **out.get("device", {})}
    verdict = out["verdict"]
    result = {"correct": bool(verdict["correct"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"], "device": dev}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checked"] = verdict["numbers"]
    notes = {"tokens_compared": verdict["tokens_compared"], "check_s": verdict["check_s"],
             "also": verdict["also"], "calls_s": out["calls_s"]}
    return result, notes


def emit(result: dict, notes: dict) -> None:
    """The compared numbers last on standard error, the result last on
    standard output."""
    print(f"calls: {len(notes['calls_s'])}, seconds each: "
          f"{' '.join(f'{c:.4f}' for c in notes['calls_s'])}", file=sys.stderr)
    print(f"check: {notes['tokens_compared']} served tokens through the reference in "
          f"{notes['check_s']:.1f} s; not compared: {json.dumps(notes['also'])}",
          file=sys.stderr)
    for name, n in result["checked"].items():
        print(f"{name} {n['value']!r} {n['rule']} {n['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"the program is missing: no {ROOT / 'src' / 'repro_torch'}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from common import Cell

    cell = Cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result, notes = execute(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                            device="cuda", t_start=T_START)
    bad = forbidden_loaded()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    emit(result, notes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
