"""Public kernel entry points, dispatched on the tensors' device.

A CPU tensor goes to the kernel's plain torch version; a CUDA tensor goes
to the hand-written kernel.  There is no fallback between the two: a CUDA
tensor either runs through the kernel or raises, and any other device
raises.
"""

from __future__ import annotations

import torch

from .placement_step import placement_sweep_cuda, placement_sweep_plain

__all__ = ["placement_sweep"]


def placement_sweep(
    shares: torch.Tensor,
    iis: torch.Tensor,
    t_slr: torch.Tensor,
    t_cfg: torch.Tensor,
    *,
    resume_cost: float = 0.0,
    repay_init: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alg-2 TFS-block placement sweep; returns ``(feasible, placed_tasks,
    n_splits, devices_used)`` on the inputs' device.  On CUDA the launch is
    asynchronous: the outputs are ready once the current stream gets there.
    The scheduler-facing entry is ``repro_torch.core.placement_backends``."""
    kind = shares.device.type
    if kind == "cpu":
        fn = placement_sweep_plain
    elif kind == "cuda":
        fn = placement_sweep_cuda
    else:
        raise ValueError(f"placement_sweep runs on cpu or cuda tensors, got {shares.device}")
    return fn(shares, iis, t_slr, t_cfg, resume_cost=resume_cost, repay_init=repay_init)
