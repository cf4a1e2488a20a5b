"""Scalar block-placement backend — the reference oracle, one row at a time.

Routes every row of the block through the exact Alg-2/Alg-3 placement
simulation (:func:`repro_torch.core.placement.place_shares`), which is the
ground truth all vectorized backends must agree with bit-for-bit.  It is
O(B) Python round-trips and exists for verification and tiny fleets, not
for throughput.

Eager by nature, its ``dispatch_block`` / ``dispatch_blocks`` hooks run
the sweep synchronously and hand back an already-resolved result —
pipelining a synchronous oracle would only reorder the Python work it is
meant to pin down — and ``dispatch_blocks_raw`` always answers ``None``
(no zero-copy surface; callers fall back per the base.py contract).  The
full five-method surface is still spelled out, and checked by
``tools/repro_lint`` rule B101, so every backend's fallback behavior is
explicit rather than an accident of ``getattr`` probing.
"""

from __future__ import annotations

import numpy as np

from ..placement import place_shares
from ..task import DeviceProfile, FleetSpec
from .base import (
    BatchPlacement,
    InstanceBatch,
    PlacementOptions,
    place_instance_blocks,
    prepare_block,
    register_backend,
)

__all__ = ["ScalarPlacementBackend"]


@register_backend("scalar")
class ScalarPlacementBackend:
    """Row-by-row scalar oracle behind the block-backend contract."""

    name = "scalar"
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
        B, n_t = shares.shape
        fleet = FleetSpec.heterogeneous(
            tuple(
                DeviceProfile(t_slr=float(s), t_cfg=float(c))
                for s, c in zip(t_slr_arr, t_cfg_arr, strict=True)
            )
        )
        feasible = np.zeros(B, dtype=bool)
        placed = np.zeros(B, dtype=np.int64)
        n_splits = np.zeros(B, dtype=np.int64)
        devices_used = np.zeros(B, dtype=np.int64)
        iis_list = [float(v) for v in iis]
        for r in range(B):
            plan = place_shares(
                [float(s) for s in shares[r]],
                iis_list,
                fleet,
                t_capture=opts.t_capture,
                t_store=opts.t_store,
                repay_init=opts.repay_init,
                resilience=opts.resilience,
            )
            feasible[r] = plan.feasible
            placed[r] = n_t - len(plan.unplaced) if not plan.feasible else n_t
            n_splits[r] = plan.n_splits
            used = [
                s.device + 1
                for s in plan.scripts
                if any(seg.kind != "null" for seg in s.segments)
            ]
            devices_used[r] = max(used, default=0)
        return BatchPlacement(
            feasible=feasible,
            placed_tasks=placed,
            n_splits=n_splits,
            devices_used=devices_used,
        )

    def dispatch_block(
        self,
        shares: np.ndarray,
        iis: np.ndarray,
        t_slr: np.ndarray,
        t_cfg: np.ndarray,
        opts: PlacementOptions | None = None,
    ):
        """Eager dispatch: the oracle sweep runs now, the resolver returns it.

        Indistinguishable from ``place_block`` by the dispatch contract;
        there is no asynchrony to exploit in a scalar Python loop.
        """
        result = self.place_block(shares, iis, t_slr, t_cfg, opts)
        return lambda: result

    def place_blocks(
        self,
        batch: InstanceBatch,
        opts: PlacementOptions | None = None,
        *,
        shard=None,
    ) -> list[BatchPlacement]:
        """Loop-over-instances — for the oracle this *is* the definition.

        ``shard`` is accepted per the batching contract and ignored (no
        device mesh; verdicts may never depend on it).
        """
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
        """No zero-copy verdict surface for the scalar oracle: always ``None``.

        ``None`` marks the batch degenerate for this backend, steering the
        many-walk onto :meth:`dispatch_blocks` (base.py's raw contract).
        """
        return None
