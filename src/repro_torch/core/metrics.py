"""Performance metrics of the scheduler (paper §IV-B, eqs. 8-10).

* Task Rejection Ratio (eq. 8):    TRR = rejected / |TSS| * 100
* System Workload (eq. 9):         sum_shr / (t_slr * n_f) * 100
* Average Task Weight (eq. 10):    mean_i(e_i / p_i)

``sweep_*`` helpers regenerate the data behind Figs 5-7: for each
(n_f, t_cfg) the TRR over the full TSS, and the *thresholds* — the maximum
system workload / average task weight among accepted combinations (a combo
whose workload/weight exceeds the threshold is rejected, §IV-B).  The
placement count runs on the ``"cuda"`` engine unless ``backend=`` asks for
another (``"torch"`` on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .feasibility import outer_sum, search_feasible
from .placement_batched import place_batch
from .task import FleetSpec, Task, combo_count

__all__ = [
    "trr",
    "system_workload",
    "avg_task_weight",
    "SweepPoint",
    "sweep_fleet",
]


def trr(n_rejected: int, n_total: int) -> float:
    """Eq. 8, in percent."""
    if n_total == 0:
        return 0.0
    return 100.0 * n_rejected / n_total


def system_workload(sum_shr: float, fleet: FleetSpec) -> float:
    """Eq. 9, in percent (heterogeneous: against sum_j t_slr_j)."""
    return 100.0 * sum_shr / fleet.capacity


def avg_task_weight(exec_times: Sequence[float], periods: Sequence[float]) -> float:
    """Eq. 10."""
    w = [e / p for e, p in zip(exec_times, periods, strict=True)]
    return float(np.mean(w))


@dataclasses.dataclass
class SweepPoint:
    """One (n_f, t_cfg) point of the Fig 5-7 sweeps."""

    n_f: int
    t_cfg: float
    n_tss: int
    n_accepted_eq7: int  # pass workability (Alg 1)
    n_accepted_placed: int  # additionally pass placement (Alg 2)
    trr_eq7: float  # Fig 5 (rejection by eq. 7)
    trr_placed: float  # rejection including placement simulation
    workload_threshold: float  # Fig 6: max eq.-9 workload among accepted
    avg_weight_threshold: float  # Fig 7: max eq.-10 weight among accepted


def _combo_avg_weights(tasks: Sequence[Task], t_slr: float) -> np.ndarray:
    """Average task weight for every TSS row (flat, C order).

    weight_ij = e_ij / p_i = shr_ij / t_slr, so the combo average is
    sum_shr / (n_t * t_slr).
    """
    share_vecs = [t.shares(t_slr) for t in tasks]
    return outer_sum(share_vecs) / (len(tasks) * t_slr)


def sweep_fleet(
    tasks: Sequence[Task],
    base: FleetSpec,
    n_f_values: Sequence[int],
    t_cfg_values: Sequence[float],
    *,
    with_placement: bool = True,
    placement_limit: int = 5_000_000,
    backend: str = "cuda",
) -> list[SweepPoint]:
    """Regenerate Figs 5-7: sweep n_f x t_cfg over the full TSS.

    Heterogeneous base fleets keep their device-class mix across the
    sweep: ``n_f`` repeats the profile pattern round-robin and ``t_cfg``
    rescales every device's cost proportionally (GPU/CPU ~0 stays ~0).
    Placement counting runs the whole TFS through the ``backend`` engine
    (:func:`place_batch`) in one block, up to ``placement_limit`` TSS rows.
    """
    tasks = tuple(tasks)
    n = combo_count(tasks)
    iis = [t.init_interval for t in tasks]
    points: list[SweepPoint] = []
    for t_cfg in t_cfg_values:
        for n_f in n_f_values:
            fleet = base.with_devices(n_f).with_t_cfg(t_cfg)
            feas = search_feasible(tasks, fleet)
            acc7 = feas.fit_mask
            n_acc7 = int(acc7.sum())
            n_placed = n_acc7
            if with_placement and n <= placement_limit and n_acc7:
                bp = place_batch(
                    feas.shares_matrix(np.flatnonzero(acc7)), iis, fleet,
                    backend=backend,
                )
                n_placed = bp.n_feasible
            workloads = 100.0 * feas.sum_shr / fleet.capacity
            weights = _combo_avg_weights(tasks, fleet.t_slr)
            wl_thr = float(workloads[acc7].max()) if n_acc7 else 0.0
            wt_thr = float(weights[acc7].max()) if n_acc7 else 0.0
            points.append(
                SweepPoint(
                    n_f=n_f,
                    t_cfg=t_cfg,
                    n_tss=n,
                    n_accepted_eq7=n_acc7,
                    n_accepted_placed=n_placed,
                    trr_eq7=trr(n - n_acc7, n),
                    trr_placed=trr(n - n_placed, n),
                    workload_threshold=wl_thr,
                    avg_weight_threshold=wt_thr,
                )
            )
    return points
