#!/usr/bin/env python3
"""Does the train step repeat itself bit for bit on the card?  A probe of
every family, for this tree or another one.

    python3 experiments/train_bitwise_probe.py [--src DIR] [--names A B ...]

Reduced models (as ``tests/test_torch_train_determinism_cuda.py`` builds
them: float32, ``attn_impl="xla"``, ``remat="full"``, seq 32, batch 4;
``name@batched`` for ``moe_impl="batched"``, ``+top6`` for 8 experts,
top-6), imported from ``--src``
(default: this tree's ``src``; give an unpacked parent's ``src`` to probe
it).  For each: two eager runs of 3 steps from one state, two captured
loops (``TrainLoop(jit=True, donate=True)``) of 3 steps from it, the
captured run against the eager one, and 8 captured steps straight against
4, a checkpoint and a fresh captured loop resumed to 8.  Prints one JSON
line a family (each pair: bitwise, and the largest difference of any state
leaf, loss or grad norm), then the card's name and power limit.  Asserts
nothing: the tests hold the port to bitwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NAMES = ["smollm-135m", "moonshot-v1-16b-a3b", "moonshot-v1-16b-a3b@batched",
         "moonshot-v1-16b-a3b@vmap+top6", "moonshot-v1-16b-a3b@batched+top6", "mamba2-130m",
         "recurrentgemma-2b", "seamless-m4t-large-v2", "qwen2-vl-2b"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--names", nargs="+", default=NAMES)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import numpy as np
    import torch

    from repro_torch._tree import leaves, tree_map
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data import make_batch_fn
    from repro_torch.models import ExecConfig, Model
    from repro_torch.optim import AdamW, linear_warmup_cosine
    from repro_torch.train import TrainLoop, TrainLoopConfig, make_train_step

    if not torch.cuda.is_available():
        print("train_bitwise_probe: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)

    def loop(name, *, jit=True, steps=3, ckpt_dir=""):
        arch, _, impl = name.partition("@")
        impl, _, top = impl.partition("+")
        cfg = get_arch(arch).reduced()
        if top:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=8, top_k=6))
        model = Model(cfg, ExecConfig(attn_impl="xla", remat="full", moe_impl=impl or "vmap"),
                      params={}, device=dev)
        return TrainLoop(model, AdamW(linear_warmup_cosine(1e-3, 1, 10)),
                         make_batch_fn(cfg, InputShape("t", 32, 4, "train"), seed=1),
                         TrainLoopConfig(total_steps=steps, ckpt_every=steps, log_every=0,
                                         ckpt_dir=ckpt_dir), jit=jit)

    def batch(lp, i):
        return {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
                for k, v in lp.batch_fn(i).items()}

    def chain(lp, step, state):
        seen = []
        for i in range(3):
            state, m = step(state, batch(lp, i))
            seen += [float(m["loss"]), float(m["grad_norm"])]
        return state, seen

    def pair(a, b):
        (sa, ma), (sb, mb) = a, b
        diffs = [float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
                 for x, y in zip(leaves(sa), leaves(sb), strict=True)]
        diffs += [abs(x - y) for x, y in zip(ma, mb, strict=True)]
        return {"bitwise": max(diffs) == 0.0, "max_abs_diff": max(diffs)}

    for name in args.names:
        eager = loop(name, jit=False)
        start = eager.init_or_resume(torch.Generator(dev).manual_seed(0))
        clone = lambda s: tree_map(lambda t: t.clone(), s)  # noqa: E731
        step = make_train_step(eager.model, eager.optimizer)
        e1, e2 = chain(eager, step, start), chain(eager, step, start)
        c1, c2 = (chain(lp, lp.step_fn, clone(start)) for lp in (loop(name), loop(name)))
        straight = loop(name, steps=8)
        sa = straight.run(torch.Generator(dev).manual_seed(6))
        with tempfile.TemporaryDirectory() as ck:
            first = loop(name, steps=8, ckpt_dir=ck)
            first.config.total_steps = first.config.ckpt_every = 4
            first.run(torch.Generator(dev).manual_seed(6))
            resumed = loop(name, steps=8, ckpt_dir=ck)
            sb = resumed.run(torch.Generator(dev).manual_seed(7))
        metrics = lambda lp: [v for h in lp.history[-4:] for v in (h["loss"], h["grad_norm"])]  # noqa: E731
        print(json.dumps({"name": name, "src": args.src, "torch": torch.__version__,
                          "eager_vs_eager": pair(e1, e2), "captured_vs_captured": pair(c1, c2),
                          "captured_vs_eager": pair(c1, e1),
                          "resume_vs_straight": pair((sb, metrics(resumed)),
                                                     (sa, metrics(straight)))}), flush=True)
        del eager, straight, first, resumed
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
