"""Torch block-placement backend — the plain sweep on CPU tensors.

Evaluates a whole ``(B, n_t)`` block of TFS rows at once with
:func:`repro_torch.kernels.placement_step.placement_sweep_plain`: the
simulation state (device cursor ``j``, remaining capacity ``c``, task
cursor ``k``, carried share ``tsd``) lives in ``(B,)`` tensors advanced by
masked carry/split steps, at most ``n_t + n_f`` of them regardless of B.
The float64 operations are the scalar oracle's in the same order, so the
two agree bit for bit.

The host block goes into torch without a copy (``torch.from_numpy``) and
the sweep runs on the CPU: this is the engine for the tests and for hosts
without a card.  It is eager — it computes in the caller's thread — so its
dispatch hooks return already-resolved results and ``async_dispatch`` is
False; the full five-method surface is spelled out anyway (B101).
"""

from __future__ import annotations

import numpy as np
import torch

from ...kernels.ops import placement_sweep
from .base import (
    BatchPlacement,
    InstanceBatch,
    PlacementOptions,
    place_instance_blocks,
    prepare_block,
    register_backend,
    survivor_tables,
)

__all__ = ["TorchPlacementBackend"]


@register_backend("torch")
class TorchPlacementBackend:
    """Masked (B,) state advance in torch on the CPU."""

    name = "torch"
    async_dispatch = False

    @classmethod
    def available(cls) -> bool:
        return True

    def place_block(
        self,
        shares: np.ndarray,
        iis: np.ndarray,
        t_slr: np.ndarray,
        t_cfg: np.ndarray,
        opts: PlacementOptions | None = None,
    ) -> BatchPlacement:
        shares, iis, t_slr_arr, t_cfg_arr, opts, early = prepare_block(
            shares, iis, t_slr, t_cfg, opts
        )
        if early is not None:
            return early
        t_shares, t_iis = torch.from_numpy(shares), torch.from_numpy(iis)
        feasible, placed, n_splits, devices_used = placement_sweep(
            t_shares, t_iis, torch.from_numpy(t_slr_arr), torch.from_numpy(t_cfg_arr),
            resume_cost=opts.resume_cost, repay_init=opts.repay_init,
        )
        if opts.resilience:
            # Second, constrained pass on the worst-case survivor fleet (see
            # base.py's resilience contract); the primary sweep keeps
            # describing the plan.
            slr_s, cfg_s = survivor_tables(t_slr_arr, t_cfg_arr, opts.resilience)
            feasible = feasible & placement_sweep(
                t_shares, t_iis, torch.from_numpy(slr_s), torch.from_numpy(cfg_s),
                resume_cost=opts.resume_cost, repay_init=opts.repay_init,
            )[0]
        return BatchPlacement(
            feasible=feasible.numpy(),
            placed_tasks=placed.numpy().astype(np.int64),
            n_splits=n_splits.numpy().astype(np.int64),
            devices_used=devices_used.numpy().astype(np.int64),
        )

    def dispatch_block(
        self,
        shares: np.ndarray,
        iis: np.ndarray,
        t_slr: np.ndarray,
        t_cfg: np.ndarray,
        opts: PlacementOptions | None = None,
    ):
        """Eager dispatch: the sweep runs now, the resolver returns it."""
        result = self.place_block(shares, iis, t_slr, t_cfg, opts)
        return lambda: result

    def place_blocks(
        self,
        batch: InstanceBatch,
        opts: PlacementOptions | None = None,
        *,
        shard=None,
    ) -> list[BatchPlacement]:
        """Loop over instances (the bit-exact reference); ``shard`` ignored."""
        return place_instance_blocks(self, batch, opts)

    def dispatch_blocks(
        self,
        batch: InstanceBatch,
        opts: PlacementOptions | None = None,
        *,
        shard=None,
    ):
        """Eager batched dispatch over :meth:`place_blocks`."""
        result = self.place_blocks(batch, opts, shard=shard)
        return lambda: result

    def dispatch_blocks_raw(
        self,
        batch: InstanceBatch,
        opts: PlacementOptions | None = None,
        *,
        shard=None,
    ):
        """No zero-copy surface here: ``None`` steers callers to the trimmed path."""
        return None
