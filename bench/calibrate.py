"""The readings a cell's limits are set from: the program's and the
control's numbers over many seeds, in one process on the card.

    python3 bench/calibrate.py --workload <cell> --seeds 1 2 3 ... [--control]

For each seed: the run's set-up, as many calls of the cell's traffic as
its sample needs (its own load), the program freed, then the run's own sample of requests through the float32 reference
and, with ``--control``, through the control: the reference itself in
float8 (``reference/quant.py``) in the program's place. The program's
number is the widest gap of a served token below the reference's best; the
control's, at each position of the same prompts and tokens, the gap of the
token the float8 reference puts first. Each seed prints one JSON line, with
the gaps split by served position (the first token comes from the prefill,
the rest from decode steps) and their quantiles.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def stats(g) -> dict:
    """Quantiles of a (rows, new) tensor of gaps, and the share at 0."""
    flat = g.flatten().float()
    q = lambda p: float(flat.quantile(p))  # noqa: E731
    out = {"max": float(flat.max()), "p99": q(0.99), "p90": q(0.9), "median": q(0.5),
           "mean": float(flat.mean()), "top1_share": float((flat <= 0).float().mean()),
           "first_max": float(g[:, 0].max()), "n": flat.numel()}
    if g.shape[1] > 1:
        out["later_max"] = float(g[:, 1:].max())
    return out


def readings(cell, seed: int, device: str, *, control: bool) -> tuple:
    """(program's gaps, control's gaps or None), each (rows, new), on one
    seed's sample after as many calls as the sample needs."""
    import torch

    serve = cell.module("runners", cell.traffic["runner"])
    quant = cell.module("reference", "quant").fp8_e4m3
    r = serve.ServeRun(cell, seed, 0.0, device, time.perf_counter())
    r.setup()
    sample = int(cell.check["sample_requests"])
    r.window(calls=-(-sample // r.traffic.batch_size))
    r.free_program()
    prog, ctl = [], []
    for batch, sel, served in r.blocks():
        served = served.to(r.device)
        ref = r.reference_logits(batch, sel, served)
        prog.append(serve.gap(ref, served))
        if control:
            low = r.reference_logits(batch, sel, served, quant=quant)
            ctl.append(serve.gap(ref, low.argmax(dim=-1)))
    return torch.cat(prog), (torch.cat(ctl) if control else None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from common import Cell

    cell = Cell(ROOT, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        prog, ctl = readings(cell, seed, args.device, control=args.control)
        rec = {"workload": args.workload, "seed": seed, "program": stats(prog)}
        if ctl is not None:
            rec["control"] = stats(ctl)
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
