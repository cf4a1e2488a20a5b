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

Fleet-parallel batching: ``dispatch_blocks_raw`` runs
:func:`repro_torch.kernels.placement_step.placement_sweep_batch_plain` over
the whole padded stack (and once more on the survivor tables under
``resilience=k``), the same two passes the ``"cuda"`` engine launches;
``dispatch_blocks`` / ``place_blocks`` trim over it.
"""

from __future__ import annotations

import numpy as np
import torch

from ...kernels.ops import placement_sweep, placement_sweep_batch
from .base import (
    BatchPlacement,
    InstanceBatch,
    PlacementOptions,
    prepare_batch,
    prepare_block,
    register_backend,
    survivor_tables,
    trim_raw_dispatch,
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
        return self.dispatch_blocks(batch, opts, shard=shard)()

    def dispatch_blocks(
        self,
        batch: InstanceBatch,
        opts: PlacementOptions | None = None,
        *,
        shard=None,
    ):
        """Per-instance verdicts, trimmed from the raw batched sweep."""
        return trim_raw_dispatch(self, batch, opts, shard=shard)

    def dispatch_blocks_raw(
        self,
        batch: InstanceBatch,
        opts: PlacementOptions | None = None,
        *,
        shard=None,
    ):
        """The plain batched sweep over the whole stack, run now; the
        resolver returns the untrimmed ``(B, R)`` verdicts.  ``None`` for a
        batch of no instance or of padded width 0.  ``shard`` is ignored."""
        opts, f64, i32 = prepare_batch(batch, opts)
        if f64 is None:
            return None
        shares, iis, t_slr, t_cfg, *surv = (torch.from_numpy(a) for a in f64)
        n_t_eff, n_f_eff, *n_f_eff_s = (torch.from_numpy(a) for a in i32)
        kw = dict(resume_cost=opts.resume_cost, repay_init=opts.repay_init)
        feasible, placed, n_splits, devices_used = placement_sweep_batch(
            shares, iis, t_slr, t_cfg, n_t_eff, n_f_eff, **kw
        )
        if opts.resilience:
            feasible = feasible & placement_sweep_batch(
                shares, iis, surv[0], surv[1], n_t_eff, n_f_eff_s[0], **kw
            )[0]
        result = tuple(o.numpy() for o in (feasible, placed, n_splits, devices_used))
        return lambda: result
