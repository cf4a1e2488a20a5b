"""CUDA block-placement backend — the hand-written sweep kernel on the card.

Each block goes host→device through a pinned staging copy, the sweep
kernel (:func:`repro_torch.kernels.placement_step.placement_sweep_cuda`)
runs one thread per row on the current stream, and the verdicts come back
device→host into pinned buffers behind a recorded ``torch.cuda.Event``.
``dispatch_block`` returns at once with a resolver that waits on that
event, so the walk's double buffering enumerates block k+1 on the host
while block k's copies and kernel run (``async_dispatch = True``).

Verdicts stay bit-identical to the scalar oracle: the kernel runs the
float64 chain in the oracle's order (the H100 has float64 in hardware, so
nothing is narrowed).  ``resilience=k`` enqueues a second launch on the
worst-case survivor tables back to back with the first, and the resolver
ANDs the two verdicts on the host.

Fleet-parallel batching: ``dispatch_blocks_raw`` stages the packed
``(B, R, n_t)`` stack, the per-instance tables and the live counts through
pinned memory, makes one launch of the instance-axis kernel
(:func:`repro_torch.kernels.placement_step.placement_sweep_batch_cuda`)
for the whole round — a second on the survivor tables under
``resilience=k`` — and copies the four ``(B, R)`` verdict arrays back into
pinned buffers behind one event; its resolver ANDs the two feasibility
arrays.  ``dispatch_blocks`` / ``place_blocks`` trim over it.  Only a batch
of padded width 0, which no sweep can take, is answered per instance by
``prepare_block``'s early paths.  ``shard`` is accepted and ignored: one
launch runs on one card.

There is no fallback: without a CUDA device the engine is unavailable and
``get_backend("cuda")`` raises; a failed build or launch raises.
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

__all__ = ["CudaPlacementBackend"]


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Enqueue a device→host copy into a pinned buffer (non-blocking)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


@register_backend("cuda")
class CudaPlacementBackend:
    """One thread per TFS row on the current CUDA device."""

    name = "cuda"
    async_dispatch = True

    def __init__(self) -> None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the 'cuda' placement engine needs a CUDA device; "
                "pass engine='torch' for the CPU"
            )
        self.device = torch.device("cuda", torch.cuda.current_device())

    @classmethod
    def available(cls) -> bool:
        return torch.cuda.is_available()

    def dispatch_block(
        self,
        shares: np.ndarray,
        iis: np.ndarray,
        t_slr: np.ndarray,
        t_cfg: np.ndarray,
        opts: PlacementOptions | None = None,
    ):
        """Enqueue copies and kernel(s); the resolver waits for the verdicts."""
        shares, iis, t_slr_arr, t_cfg_arr, opts, early = prepare_block(
            shares, iis, t_slr, t_cfg, opts
        )
        if early is not None:
            return lambda: early
        n_t, n_f = iis.shape[0], t_slr_arr.shape[0]
        tables = [iis, t_slr_arr, t_cfg_arr]
        if opts.resilience:
            # Survivors are picked at float64 on the host, from the fleet alone.
            tables.extend(survivor_tables(t_slr_arr, t_cfg_arr, opts.resilience))
        # Pinned staging: the host→device copies are truly asynchronous.
        # The resolver holds the staging tensors until the event, so no
        # buffer is reused while a copy may still read it.
        staging = (
            torch.from_numpy(shares).pin_memory(),
            torch.from_numpy(np.concatenate(tables)).pin_memory(),
        )
        d_shares = staging[0].to(self.device, non_blocking=True)
        d_tables = staging[1].to(self.device, non_blocking=True)
        d_iis = d_tables[:n_t]
        d_slr = d_tables[n_t : n_t + n_f]
        d_cfg = d_tables[n_t + n_f : n_t + 2 * n_f]
        kw = dict(resume_cost=opts.resume_cost, repay_init=opts.repay_init)
        outs = placement_sweep(d_shares, d_iis, d_slr, d_cfg, **kw)
        h_outs = [_to_host(t) for t in outs]
        if opts.resilience:
            m = n_f - opts.resilience
            base = n_t + 2 * n_f
            feas_s = placement_sweep(
                d_shares, d_iis, d_tables[base : base + m], d_tables[base + m : base + 2 * m], **kw
            )[0]
            h_outs.append(_to_host(feas_s))
        done = torch.cuda.Event()
        done.record()

        def resolve() -> BatchPlacement:
            nonlocal staging
            done.synchronize()
            staging = None  # the copies have read it: free to go
            feasible = h_outs[0].numpy()
            if opts.resilience:
                feasible = feasible & h_outs[4].numpy()
            return BatchPlacement(
                feasible=feasible,
                placed_tasks=h_outs[1].numpy().astype(np.int64),
                n_splits=h_outs[2].numpy().astype(np.int64),
                devices_used=h_outs[3].numpy().astype(np.int64),
            )

        return resolve

    def place_block(
        self,
        shares: np.ndarray,
        iis: np.ndarray,
        t_slr: np.ndarray,
        t_cfg: np.ndarray,
        opts: PlacementOptions | None = None,
    ) -> BatchPlacement:
        return self.dispatch_block(shares, iis, t_slr, t_cfg, opts)()

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
        """Enqueue the round's launch(es); the resolver trims per instance."""
        return trim_raw_dispatch(self, batch, opts, shard=shard)

    def dispatch_blocks_raw(
        self,
        batch: InstanceBatch,
        opts: PlacementOptions | None = None,
        *,
        shard=None,
    ):
        """Enqueue copies and the batched kernel; the resolver waits for the
        untrimmed ``(B, R)`` verdicts.  ``None`` for a batch of no instance
        or of padded width 0.  ``shard`` is ignored."""
        opts, f64, i32 = prepare_batch(batch, opts)
        if f64 is None:
            return None
        shares, *tables = f64
        B = shares.shape[0]
        # Three pinned staging buffers (shares, float64 tables, int32
        # counts), held by the resolver until its event as in dispatch_block.
        staging = (
            torch.from_numpy(shares).pin_memory(),
            torch.from_numpy(np.concatenate([a.ravel() for a in tables])).pin_memory(),
            torch.from_numpy(np.concatenate(i32)).pin_memory(),
        )
        d_shares, d_tables, d_counts = (t.to(self.device, non_blocking=True) for t in staging)
        iis, t_slr, t_cfg, *surv = (
            t.view(B, -1) for t in torch.split(d_tables, [a.size for a in tables])
        )
        n_t_eff, n_f_eff, *n_f_eff_s = torch.split(d_counts, B)
        kw = dict(resume_cost=opts.resume_cost, repay_init=opts.repay_init)
        outs = placement_sweep_batch(d_shares, iis, t_slr, t_cfg, n_t_eff, n_f_eff, **kw)
        h_outs = [_to_host(t) for t in outs]
        if opts.resilience:
            feas_s = placement_sweep_batch(
                d_shares, iis, surv[0], surv[1], n_t_eff, n_f_eff_s[0], **kw
            )[0]
            h_outs.append(_to_host(feas_s))
        done = torch.cuda.Event()
        done.record()

        def resolve_raw():
            nonlocal staging
            done.synchronize()
            staging = None  # the copies have read it: free to go
            feasible = h_outs[0].numpy()
            if opts.resilience:
                feasible = feasible & h_outs[4].numpy()
            return feasible, h_outs[1].numpy(), h_outs[2].numpy(), h_outs[3].numpy()

        return resolve_raw
