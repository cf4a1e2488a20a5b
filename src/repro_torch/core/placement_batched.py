"""Batched Alg-2/Alg-3 placement entry points over the backends.

* :func:`place_batch` — place a ``(B, n_t)`` shares block on the fleet
  through a placement engine (``"cuda"`` by default, ``"torch"`` on the
  CPU, or ``"scalar"``);
* :class:`BatchPlacement` — re-exported from the backend package;
* :func:`place_combos_batch` — the Alg-3 combo-block entry point.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .placement_backends import BatchPlacement, PlacementOptions, get_backend
from .task import FleetSpec, Task, TaskSetCombo

__all__ = ["BatchPlacement", "place_batch", "place_combos_batch"]


def place_batch(
    shares: np.ndarray,
    init_intervals: Sequence[float],
    fleet: FleetSpec,
    *,
    t_capture: float = 0.0,
    t_store: float = 0.0,
    repay_init: bool = True,
    backend: str = "cuda",
) -> BatchPlacement:
    """Simulate DP-wrap placement of ``B`` share rows on the fleet at once.

    ``shares`` is ``(B, n_t)`` — one power-sorted TFS row per line, tasks in
    the paper's fixed order.  Semantics (start condition, split carry,
    re-paid II / capture+store, closure) are exactly those of
    :func:`repro_torch.core.placement.place_shares`.  ``backend`` selects
    the block engine (:mod:`repro_torch.core.placement_backends`): the
    default ``"cuda"`` needs a CUDA device and raises without one; pass
    ``"torch"`` for the CPU.  Every engine agrees with the scalar oracle
    bit for bit.

    Example — two rows on a 2x30 fleet (``t_cfg=1``): the first fits with
    one DP-wrap split, the second still has share left after the last
    device and is rejected:

        >>> import numpy as np
        >>> from repro_torch.core.task import FleetSpec
        >>> fleet = FleetSpec(n_f=2, t_slr=30.0, t_cfg=1.0)
        >>> bp = place_batch(
        ...     np.array([[20.0, 30.0], [40.0, 25.0]]), [1.0, 1.0], fleet,
        ...     backend="torch")
        >>> bp.feasible.tolist(), bp.n_splits.tolist()
        ([True, False], [1, 2])
        >>> bp.first_feasible()
        0
    """
    opts = PlacementOptions(
        t_capture=t_capture, t_store=t_store, repay_init=repay_init
    )
    return get_backend(backend).place_block(
        shares, init_intervals, fleet.t_slr_arr, fleet.t_cfg_arr, opts
    )


def place_combos_batch(
    combos: Sequence[TaskSetCombo],
    tasks: Sequence[Task],
    fleet: FleetSpec,
    **kw,
) -> BatchPlacement:
    """Batch-place a block of materialised TSS rows (Alg 3 entry point)."""
    shares = np.asarray([cb.shares for cb in combos], dtype=np.float64)
    iis = [t.init_interval for t in tasks]
    return place_batch(shares, iis, fleet, **kw)
