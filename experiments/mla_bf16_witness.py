"""How far bfloat16 alone moves moonlight-16b-a3b's greedy tokens from the
float32 reference, at the benchmark cell's full size (27 layers): the
witness beside the cell's check, whose limits hold a median gap and a match
share, not the widest gap.

    python3 experiments/mla_bf16_witness.py --workload moonlight-chat-decode \\
        --seeds 4026531841 6442450951 [--out build/mla_bf16_witness.json]

from the root of a checkout, on a card.  For each seed, as
``bench/calibrate.py`` does: the run's set-up, as many calls of the cell's
traffic as its check's sample needs, the program freed; then over the
run's own sample of requests (each prompt and its served tokens) the
float32 reference (``bench/reference/mla_moe.py``) and the same reference
with every product's operands rounded to bfloat16 (the router's scores
stay float32, as under the cell's float8 control).  Printed for each seed,
by ``runners/serve.py: numbers``: the program's served tokens against the
float32 reference, and the bfloat16 reference's greedy tokens against it
at the same positions.  If bfloat16 alone reads a match share near the
program's, the program's low share is the precision's, not a fault of its
own.  Nothing of ``bench/`` is changed.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

import torch  # noqa: E402


def bf16(x: torch.Tensor, *, rows: bool) -> torch.Tensor:
    """``x`` rounded to bfloat16 and widened back (``rows`` is the float8
    control's scaling switch; bfloat16 needs no scale)."""
    del rows
    return x.to(torch.bfloat16).float()


def readings(cell, seed: int, device: str) -> dict:
    serve = cell.module("runners", cell.traffic["runner"])
    r = serve.ServeRun(cell, seed, 0.0, device, time.perf_counter())
    r.setup()
    sample = int(cell.check["sample_requests"])
    r.window(calls=-(-sample // r.traffic.batch_size))
    r.free_program()
    prog, low = [], []
    for batch, sel, served in r.blocks():
        served = served.to(r.device)
        ref = r.reference_logits(batch, sel, served)
        prog.append(serve.gap(ref, served))
        low.append(serve.gap(ref, r.reference_logits(batch, sel, served, quant=bf16)
                             .argmax(dim=-1)))
    return {"program": serve.numbers(torch.cat(prog)),
            "reference_bf16": serve.numbers(torch.cat(low))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="moonlight-chat-decode")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from common import Cell

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = Cell(ROOT, args.workload)
    recs = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        rec = {"workload": args.workload, "seed": seed, **readings(cell, seed, args.device),
               "seconds": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
