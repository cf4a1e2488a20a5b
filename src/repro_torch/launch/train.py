"""Training launcher.

Reduced configs (the default) train a small twin of the arch; ``--full``
trains the published widths and depths.  The model computes in
``cfg.dtype`` on float32 master weights, on the differentiable route
(``ExecConfig(attn_impl="xla")``: the hand-written kernels have no
backward), with the config's activation checkpointing (``cfg.remat``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --ckpt-dir /tmp/ckpt --seq-len 256 --batch 8 --device cpu

The flags are the JAX package's ``launch/train.py``'s, plus ``--device``:
``cuda`` (the default) trains on the card and raises without one; ``cpu``
trains on the CPU.  ``build_loop`` builds ``TrainLoop`` with the
reference's defaults, ``jit=True, donate=True``: on the card every step is
a replay of one CUDA graph of the whole step over the donated train state
(the first step warms up and captures); on the CPU the steps run eagerly.
"""

from __future__ import annotations

import argparse

import torch

from ..configs import get_arch, list_archs
from ..configs.shapes import InputShape
from ..data.pipeline import make_batch_fn
from ..models import ExecConfig, Model
from ..optim import AdamW, linear_warmup_cosine
from ..train import TrainLoop, TrainLoopConfig

__all__ = ["main", "build_loop"]


def build_loop(
    arch: str,
    *,
    full: bool = False,
    seq_len: int = 256,
    batch: int = 8,
    steps: int = 100,
    ckpt_dir: str = "",
    lr: float = 3e-4,
    microbatch: int = 0,
    compress_grads: bool = False,
    log_every: int = 10,
    device: torch.device | str = "cuda",
) -> tuple[TrainLoop, InputShape]:
    """The JAX package's loop, on ``device`` (a CUDA device on a host
    without one raises): ``TrainLoop``'s defaults, so captured and donated
    on the card, eager on the CPU."""
    cfg = get_arch(arch)
    if not full:
        cfg = cfg.reduced()
    shape = InputShape("cli", seq_len, batch, "train")
    # params={}: the weights are the train state's, not the model's
    model = Model(cfg, ExecConfig(attn_impl="xla", remat=cfg.remat), params={}, device=device)
    opt = AdamW(linear_warmup_cosine(lr, max(steps // 20, 1), steps))
    loop = TrainLoop(
        model,
        opt,
        make_batch_fn(cfg, shape),
        TrainLoopConfig(
            total_steps=steps,
            ckpt_every=max(steps // 4, 1),
            log_every=log_every,
            ckpt_dir=ckpt_dir,
            microbatch=microbatch,
            compress_grads=compress_grads,
        ),
    )
    return loop, shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--full", action="store_true", help="full (non-reduced) config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    loop, _ = build_loop(
        args.arch,
        full=args.full,
        seq_len=args.seq_len,
        batch=args.batch,
        steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        lr=args.lr,
        microbatch=args.microbatch,
        compress_grads=args.compress_grads,
        device=args.device,
    )
    state = loop.run(torch.Generator(loop.model.device).manual_seed(args.seed))
    first = loop.history[0]["loss"] if loop.history else float("nan")
    last = loop.history[-1]["loss"] if loop.history else float("nan")
    print(f"done: step={int(state.step)} loss {first:.4f} -> {last:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
