"""Baseline schedulers the paper compares against (§I, §IV-C, Table III).

* ``preemptive_dpfair`` — the scheduler model of refs [9]/[10]: same
  DP-fair/DP-wrap placement, but a *preempted* (split) task resumes by
  capturing + storing + re-writing its bitstream context instead of paying a
  fresh II.  The papers *ignored* the capture/store cost; with it charged
  honestly (``t_capture + t_store`` per preemption, ~150 ms for an
  Alveo-class xclbin per §IV-C) fewer task sets fit → higher TRR (Fig 8).
* ``edf`` / ``llf`` — greedy Earliest-Deadline-First / Least-Laxity-First
  per-slice assignment, shown by ref. [4] to be non-optimal on parallel
  fleets; they also do not bound context switches.
* ``erfair`` — quantum-level proportional-progress scheduling (ref. [7]);
  optimal on CPUs but each quantum boundary is a potential migration, i.e.
  an uncontrolled number of reconfigurations on FPGA/TPU fleets.  We count
  them to reproduce the paper's cost argument.

The functions that place rows take ``backend=`` (the placement engine,
``"cuda"`` by default; ``"torch"`` on the CPU).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Sequence

import numpy as np

from .feasibility import search_feasible
from .placement_batched import place_batch
from .scheduler import ScheduleResult, _select_from_feasibility
from .task import FleetSpec, Task

__all__ = [
    "preemptive_dpfair_schedule",
    "count_placeable",
    "GreedyResult",
    "edf_schedule",
    "llf_schedule",
    "erfair_context_switches",
]


def preemptive_dpfair_schedule(
    tasks: Sequence[Task],
    fleet: FleetSpec,
    *,
    t_capture: float,
    t_store: float,
    count_all_rejects: bool = False,
    backend: str = "cuda",
) -> ScheduleResult:
    """Refs [9]/[10] with honest context capture/store accounting.

    Identical search to PADPS-FR but split tasks pay
    ``t_capture + t_store`` on resume instead of a fresh ``II`` —
    and keep their partial context (no data re-split).
    """
    tasks = tuple(tasks)
    feas = search_feasible(tasks, fleet)
    combo, plan, rank, rejects = _select_from_feasibility(
        feas,
        tasks,
        fleet,
        count_all_rejects=count_all_rejects,
        backend=backend,
        t_capture=t_capture,
        t_store=t_store,
        repay_init=False,
    )
    return ScheduleResult(
        feasible=combo is not None,
        combo=combo,
        plan=plan,
        chosen_rank=rank,
        n_tss=feas.n_combos,
        n_tfs=feas.n_tfs,
        n_tnfs=feas.n_tnfs,
        n_placement_rejects=rejects,
        total_power=combo.total_power if combo else float("inf"),
    )


def count_placeable(
    tasks: Sequence[Task],
    fleet: FleetSpec,
    *,
    backend: str = "cuda",
    **placement_kw,
) -> tuple[int, int, int]:
    """(n_tss, n_eq7_accepted, n_placeable) under the given placement model.

    The Fig 8 comparison: ``n_placeable`` with fresh-II re-pay (ours) vs
    with capture/store overhead (refs [9]/[10]).  The whole TFS goes
    through the batched placement engine in one sweep."""
    tasks = tuple(tasks)
    feas = search_feasible(tasks, fleet)
    tfs = np.flatnonzero(feas.fit_mask)
    if tfs.size == 0:
        return feas.n_combos, 0, 0
    bp = place_batch(
        feas.shares_matrix(tfs),
        [t.init_interval for t in tasks],
        fleet,
        backend=backend,
        **placement_kw,
    )
    return feas.n_combos, feas.n_tfs, bp.n_feasible


@dataclasses.dataclass
class GreedyResult:
    feasible: bool
    assignment: list[list[int]]  # per device, task indices in run order
    finish_times: list[float]  # per task
    missed: list[int]  # tasks missing their period
    n_context_switches: int
    total_power: float


def _greedy_assign(
    tasks: Sequence[Task],
    fleet: FleetSpec,
    priority: str,
) -> GreedyResult:
    """Greedy list scheduling: at each step the highest-priority pending task
    goes to the earliest-available device.  Priorities: EDF (earliest
    period/deadline) or LLF (least laxity = deadline - exec time).

    Every task uses its *fastest* variant (greedy schedulers in the cited
    literature are power-oblivious).  Context switches = number of
    placements (each placement is one reconfiguration).
    """
    n_t = len(tasks)
    # fastest variant = max throughput = min exec time
    exec_t = np.array([t.exec_times().min() for t in tasks])
    power = np.array(
        [t.variants[int(np.argmin(t.exec_times()))].power for t in tasks]
    )
    deadline = np.array([t.period for t in tasks])
    if priority == "edf":
        key = deadline
    elif priority == "llf":
        key = deadline - exec_t
    else:  # pragma: no cover
        raise ValueError(priority)
    order = np.lexsort((np.arange(n_t), key))

    # device heap: (available_time, device)
    heap = [(0.0, j) for j in range(fleet.n_f)]
    heapq.heapify(heap)
    assignment: list[list[int]] = [[] for _ in range(fleet.n_f)]
    finish = [0.0] * n_t
    switches = 0
    for k in order:
        k = int(k)
        avail, j = heapq.heappop(heap)
        start = avail + fleet.t_cfg_of(j) + tasks[k].init_interval
        # Heterogeneous capacity derating: a device with t_slr_j below the
        # reference slice does the same work proportionally slower.
        end = start + exec_t[k] * (fleet.t_slr / fleet.t_slr_of(j))
        assignment[j].append(k)
        finish[k] = end
        switches += 1
        heapq.heappush(heap, (end, j))
    missed = [k for k in range(n_t) if finish[k] > deadline[k] + 1e-9]
    return GreedyResult(
        feasible=not missed,
        assignment=assignment,
        finish_times=finish,
        missed=missed,
        n_context_switches=switches,
        total_power=float(power.sum()),
    )


def edf_schedule(tasks: Sequence[Task], fleet: FleetSpec) -> GreedyResult:
    return _greedy_assign(tasks, fleet, "edf")


def llf_schedule(tasks: Sequence[Task], fleet: FleetSpec) -> GreedyResult:
    return _greedy_assign(tasks, fleet, "llf")


def erfair_context_switches(
    tasks: Sequence[Task],
    fleet: FleetSpec,
    quantum: float,
) -> int:
    """Count the reconfigurations ER-fair (ref. [7]) would incur.

    ER-fair enforces proportional progress every quantum: each task must
    have completed >= w_i * t by slot t.  On a reconfigurable fleet every
    quantum in which a device switches tasks costs a full reconfiguration.
    We simulate the canonical ER-fair allocation over one hyper-slice and
    count switches — the paper's argument is that this number is
    uncontrolled (grows with t_slr / quantum), vs <= n_t + n_f - 1 splits
    for DP-wrap.
    """
    n_t = len(tasks)
    weights = np.array(
        [t.shares(fleet.t_slr)[0] / fleet.t_slr for t in tasks]
    )  # 1-CU weights
    done = np.zeros(n_t)
    running = [-1] * fleet.n_f  # task on each device
    switches = 0
    steps = int(round(fleet.t_slr / quantum))
    for step in range(1, steps + 1):
        t_now = step * quantum
        lag = weights * t_now - done  # ER-fair lag
        order = np.argsort(-lag)
        chosen = [int(k) for k in order[: fleet.n_f] if lag[int(k)] > 1e-12]
        for slot, k in enumerate(chosen):
            if running[slot] != k:
                switches += 1
                running[slot] = k
            done[k] += quantum
        for slot in range(len(chosen), fleet.n_f):
            running[slot] = -1
    return switches
