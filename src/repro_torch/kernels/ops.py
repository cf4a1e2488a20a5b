"""Public kernel entry points, dispatched on the tensors' device.

A CPU tensor goes to the kernel's plain torch version; a CUDA tensor goes
to the hand-written kernel.  There is no fallback between the two: a CUDA
tensor either runs through the kernel or raises, and any other device
raises.
"""

from __future__ import annotations

import torch

from .placement_step import (
    placement_sweep_batch_cuda,
    placement_sweep_batch_plain,
    placement_sweep_cuda,
    placement_sweep_plain,
)

__all__ = ["placement_sweep", "placement_sweep_batch"]


def _pick(t: torch.Tensor, plain, kernel, name: str):
    kind = t.device.type
    if kind == "cpu":
        return plain
    if kind == "cuda":
        return kernel
    raise ValueError(f"{name} runs on cpu or cuda tensors, got {t.device}")


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
    fn = _pick(shares, placement_sweep_plain, placement_sweep_cuda, "placement_sweep")
    return fn(shares, iis, t_slr, t_cfg, resume_cost=resume_cost, repay_init=repay_init)


def placement_sweep_batch(
    shares: torch.Tensor,
    iis: torch.Tensor,
    t_slr: torch.Tensor,
    t_cfg: torch.Tensor,
    n_t_eff: torch.Tensor,
    n_f_eff: torch.Tensor,
    *,
    resume_cost: float = 0.0,
    repay_init: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fleet-parallel sweep over a ``(B, R, n_t)`` instance stack; returns
    ``(feasible, placed_tasks, n_splits, devices_used)`` as ``(B, R)`` on
    the inputs' device.  Ragged instances arrive padded: ``n_t_eff`` /
    ``n_f_eff`` (int32) carry each instance's live widths.  On CUDA the
    launch is asynchronous.  The scheduler-facing entry is
    ``PADPSFRScheduler.schedule_many``."""
    fn = _pick(shares, placement_sweep_batch_plain, placement_sweep_batch_cuda,
               "placement_sweep_batch")
    return fn(shares, iis, t_slr, t_cfg, n_t_eff, n_f_eff,
              resume_cost=resume_cost, repay_init=repay_init)
