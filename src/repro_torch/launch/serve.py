"""Serving launcher: batched prefill + greedy decode on a reduced config.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --batch 4 --prompt-len 64 --new-tokens 32 --device cpu

The flags are the JAX package's ``launch/serve.py``'s, plus ``--device``:
``cuda`` (the default) runs the kernels on the card and raises without
one; ``cpu`` runs their plain versions; ``--eos-id``: a row stops at this
token (the engine's stop check, which reads the card once a step); and
``--trace``: a second ``generate`` of the same batch with the program's
tracing on (``repro_torch.trace``), after which the launcher prints the
counters (``trace.snapshot()``), the kernels' launches (the wrappers'
counts, ``kernels.counts``, and on a card what one replay of each
captured step launches, ``CudaGraphStep.launches``: the decode step's
``decode_attention`` one a layer) and each span's ms a step
(``trace.spans()``: the device's on a card, the host's clock on the CPU;
``serve.stop`` is the stop check's).  Every registered ``--arch`` is
served at its reduced width.  The stub frontends get the JAX package's
inputs: an enc-dec model ``prompt-len`` random frame embeddings, a vision
model 8 random patch embeddings in place of its first 8 prompt tokens.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import trace
from ..configs import get_arch, list_archs
from ..kernels import counts
from ..models import Model
from ..models.model import resolve_device
from ..serve import ServeConfig, ServeEngine
from ..serve.graphs import CudaGraphStep

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop a row at this token (-1, the default: never)")
    ap.add_argument("--trace", action="store_true",
                    help="generate again with tracing on; print its spans and counters")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).reduced()
    device = resolve_device(args.device)  # raises for cuda on a host without a card
    model = Model(cfg, generator=torch.Generator(device).manual_seed(args.seed), device=device)

    rng = np.random.default_rng(args.seed)
    B, S = args.batch, args.prompt_len
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["enc_embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        P = 8
        batch = {
            "tokens": batch["tokens"][:, : S - P],
            "patch_embeds": rng.standard_normal((B, P, cfg.d_model)).astype(np.float32),
            "positions": np.broadcast_to(np.arange(S)[None, :, None], (B, S, 3)).astype(np.int32),
        }

    engine = ServeEngine(
        model, ServeConfig(max_len=S + args.new_tokens, temperature=args.temperature,
                           eos_id=args.eos_id)
    )
    t0 = time.perf_counter()
    out = engine.generate(
        batch, args.new_tokens, generator=torch.Generator(model.device).manual_seed(args.seed)
    )
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    tput = B * out.shape[1] / dt
    print(f"generated {tuple(out.shape)} tokens in {dt:.2f}s ({tput:.1f} tok/s) on {model.device}")
    print("first row:", out[0][:16].cpu().numpy())
    if args.trace:
        with trace.enabled():
            engine.generate(batch, args.new_tokens,
                            generator=torch.Generator(model.device).manual_seed(args.seed))
        print("counters:", " ".join(f"{k}={v:g}" if isinstance(v, (int, float)) else f"{k}={v}"
                                    for k, v in sorted(trace.snapshot().items())))
        print("launches (wrappers):",
              " ".join(f"{k}={n}" for k, n in counts.read().items() if n) or "none")
        for name, step in (("prefill", engine._prefill), ("decode", engine._decode)):
            if isinstance(step, CudaGraphStep):
                for key in step.graphs:
                    print(f"launches a {name} replay:",
                          " ".join(f"{k}={n}" for k, n in step.launches(key).items()))
        for name, ms in sorted(trace.spans().items()):
            print(f"span {name}: {sum(ms) / len(ms):.3f} ms a step over {len(ms)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
