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

There is no fallback: without a CUDA device the engine is unavailable and
``get_backend("cuda")`` raises; a failed build or launch raises.  The
batched surface loops over instances (:func:`place_instance_blocks`); a
kernel with an instance axis comes later, so ``dispatch_blocks_raw``
answers ``None``.
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
        """Loop over instances (one launch each); ``shard`` is ignored."""
        return place_instance_blocks(self, batch, opts)

    def dispatch_blocks(
        self,
        batch: InstanceBatch,
        opts: PlacementOptions | None = None,
        *,
        shard=None,
    ):
        """Enqueue every instance's block; the resolver syncs them in order."""
        resolvers = [
            self.dispatch_block(*batch.instance_view(i), opts) for i in range(len(batch))
        ]
        return lambda: [r() for r in resolvers]

    def dispatch_blocks_raw(
        self,
        batch: InstanceBatch,
        opts: PlacementOptions | None = None,
        *,
        shard=None,
    ):
        """No zero-copy surface until the instance-axis kernel lands: ``None``."""
        return None
