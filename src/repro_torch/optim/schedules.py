"""Learning-rate schedules (pure functions of the step counter).

Each returns a float32 0-d tensor on the step's device, computed in the
JAX package's float32 arithmetic and order of operations.
"""

from __future__ import annotations

import math

import torch

__all__ = ["constant_lr", "cosine_lr", "linear_warmup_cosine"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_lr(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def cosine_lr(peak: float, total_steps: int, final_frac: float = 0.1):
    def sched(step):
        t = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return peak * (final_frac + (1 - final_frac) * cos)

    return sched


def linear_warmup_cosine(
    peak: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1
):
    def sched(step):
        s = _f32(step)
        warm = peak * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak * (final_frac + (1 - final_frac) * 0.5 * (1.0 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)

    return sched
