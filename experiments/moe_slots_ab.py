#!/usr/bin/env python3
"""Four ways for the MoE layer's ``_slots`` to read each token ``top_k``
times, timed on the card at moonshot-v1-16b-a3b's widths.

    python3 experiments/moe_slots_ab.py [--shapes 2x256 8x1024 8x4096] [--reps 20]

* ``gather``: ``torch.gather(x, 1, order // top_k)`` (the layer before the
  change), whose backward adds each token's ``top_k`` rows with atomics;
* ``expand``: ``x`` expanded to (B, S, top_k, D), flattened to the pairs
  and gathered with ``order`` (a permutation: its backward writes each pair
  once, and the expand's backward sums a token's ``top_k`` copies);
* ``index``: ``x[b, order // top_k]``, whose backward is
  ``index_put_(accumulate=True)`` (on the card: the indices sorted, each
  token's rows added in one order);
* ``layer``: the layer's own ``layers._TokenRows``, ``gather``'s forward
  with ``index``'s backward.

For each shape and dtype (bfloat16, the train step's; float32): the four
forwards bitwise equal; each backward run twice on the same inputs and
cotangent, bitwise equal or not, with the largest difference; and the
median ms of the forward alone (no grad, as serving runs it) and of
forward + backward over ``--reps`` runs (CUDA events), the four in turns.  Routes come from ``layers._route`` at the layer's default
capacity factor on seeded inputs.  Prints one JSON line a shape and dtype,
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import layers  # noqa: E402


def _gather(x, order, k):
    B, SK = order.shape
    return torch.gather(x, 1, (order // k)[..., None].expand(B, SK, x.shape[-1]))


def _expand(x, order, k):
    B, S, D = x.shape
    pairs = x[:, :, None, :].expand(B, S, k, D).reshape(B, S * k, D)
    return torch.gather(pairs, 1, order[..., None].expand(B, S * k, D))


def _index(x, order, k):
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, order // k]


def _layer(x, order, k):
    return layers._TokenRows.apply(x, order // k)


FORMS = {"gather": _gather, "expand": _expand, "index": _index, "layer": _layer}


def _fwd_bwd(fn, x, order, k, cot):
    xl = x.detach().requires_grad_(True)
    out = fn(xl, order, k)
    (g,) = torch.autograd.grad(out, xl, cot)
    return out, g


def _ms(fn, x, order, k, cot, reps: int, grad: bool = True) -> list:
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        if grad:
            _fwd_bwd(fn, x, order, k, cot)
        else:
            with torch.no_grad():
                fn(x, order, k)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", nargs="+", default=["2x256", "8x1024", "8x4096"])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("moe_slots_ab: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cfg = get_arch("moonshot-v1-16b-a3b")
    D, E, k, cf = cfg.d_model, cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.capacity
    for shape in args.shapes:
        B, S = map(int, shape.split("x"))
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(dev).manual_seed(B * S)
            x = torch.randn((B, S, D), generator=g, device=dev).to(dtype)
            router = torch.randn((D, E), generator=g, device=dev) * 0.02
            capacity = max(1, int(math.ceil(S * k / E * cf)))  # moe_layer's
            order = layers._route(x, router, top_k=k, capacity=capacity)[-1]
            cot = torch.randn((B, S * k, D), generator=g, device=dev).to(dtype)
            rec = {"B": B, "S": S, "D": D, "E": E, "top_k": k, "dtype": str(dtype)[6:]}
            outs = {}
            for name, fn in FORMS.items():
                o1, g1 = _fwd_bwd(fn, x, order, k, cot)
                o2, g2 = _fwd_bwd(fn, x, order, k, cot)
                outs[name] = o1
                rec[name] = {"backward_repeats_bitwise": bool(torch.equal(g1, g2)),
                             "backward_repeat_max_abs_diff": float((g1.float() - g2.float())
                                                                   .abs().max())}
            rec["forwards_bitwise_equal"] = all(torch.equal(outs["gather"], o)
                                                for o in outs.values())
            for grad, key in ((False, "ms_fwd_median"), (True, "ms_fwd_bwd_median")):
                times = {name: [] for name in FORMS}
                for _ in range(2):  # in turns: each form, then the same in reverse
                    for name in (*FORMS, *reversed(FORMS)):
                        times[name] += _ms(FORMS[name], x, order, k, cot, args.reps // 4 or 1,
                                           grad)
                for name in FORMS:
                    rec[name][key] = statistics.median(times[name])
            print(json.dumps(rec), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
