"""Algorithms 2 & 3 — placement of a task-set combination onto the fleet.

This module implements the paper's ``find_low_power_task_set()`` routine
(Alg 2 lines 11-29 / Alg 3 lines 6-27) once, as a full placement simulator
that both answers *is this combo placeable?* (Alg 2) and produces the
per-device script/Gantt plan with data splits (Alg 3).

Semantics, pinned against the paper's worked examples (Figs 2-4):

* Placing task ``k`` fresh on a device costs ``t_cfg + shr_k``; the share
  *includes one initialization interval* II_k ("The total share of 2CU-T3
  is 24 including II 2 ms", §IV-A1), so T2 (cfg 6 + shr 36) finishes at
  42 ms on F2 exactly as the paper states.
* A task may only *start* on a device whose remaining capacity strictly
  exceeds ``t_cfg + II_k`` (Example 2: remaining 18 vs 6+12=18 → rejected).
* If ``c - t_cfg < shr_k`` the task splits: ``tsd = c - t_cfg`` of its share
  runs here and the remainder carries to the next device, where it pays
  ``t_cfg`` *and a fresh II_k* again ("the hardware again needs 2 ms II",
  §IV-A1 — this is the ``- II_k`` term of pseudocode line 22, which applies
  to carried tasks; charging it to fresh placements would double-count the
  II already inside the share, contradicting the 42 ms figure).
* After fully placing ``k``, if the leftover is within ``t_cfg + II_k`` the
  device is closed (a NULL slice remains) and the next task starts on the
  next device.
* Input data of a split task is divided in the ratio ``tsd : shr_k - tsd``
  (Alg 3 lines 12-14; the paper splits T3's 24 GB 1:1 for a 12:12 share
  split — proportional to share, not to data-generating time).

The pseudocode's success test ``sti == n_t and tsd == 0`` is off by one for
1-based loops; we use the intended condition: every task fully placed
within ``n_f`` devices.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .task import FleetSpec, Task, TaskSetCombo

__all__ = [
    "Segment",
    "DeviceScript",
    "PlacementPlan",
    "place_combo",
    "place_shares",
]

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class Segment:
    """One contiguous occupancy of a device within the time slice.

    ``kind`` is one of ``cfg`` (reconfiguration), ``init`` (re-paid II of a
    carried split task), ``run`` (share execution; for fresh placements the
    leading II_k is inside ``run``, matching the paper's accounting), or
    ``null`` (NULL slice, Fig 2).
    """

    kind: str
    task: int  # task index, -1 for null
    start: float
    end: float

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class DeviceScript:
    """Per-device placement script (Alg 3's ``fpga_script_j``)."""

    device: int
    segments: list[Segment] = dataclasses.field(default_factory=list)

    @property
    def used(self) -> float:
        return sum(s.dur for s in self.segments if s.kind != "null")

    def null_time(self, t_slr: float) -> float:
        return t_slr - self.used


@dataclasses.dataclass
class DataSplit:
    """How a split task's input data divides across devices (Alg 3 l.12-14)."""

    task: int
    devices: tuple[int, ...]
    share_parts: tuple[float, ...]

    @property
    def ratio(self) -> tuple[float, ...]:
        tot = sum(self.share_parts)
        return tuple(p / tot for p in self.share_parts)


@dataclasses.dataclass
class PlacementPlan:
    """Result of placing one combo on the fleet."""

    feasible: bool
    scripts: list[DeviceScript]
    splits: list[DataSplit]
    unplaced: list[int]  # task indices that did not fit
    executed_share: list[float]  # per task, total share actually placed
    # Resilience mode (``place_shares(..., resilience=k)``): the backup
    # placement on the worst-case survivor fleet that proves the combo
    # still meets deadlines after any k device failures.  ``feasible``
    # is then the combined primary-AND-backup verdict.
    backup: "PlacementPlan | None" = None

    @property
    def n_splits(self) -> int:
        return len(self.splits)

    def device_of(self, task: int) -> list[int]:
        out = []
        for s in self.scripts:
            if any(seg.task == task and seg.kind == "run" for seg in s.segments):
                out.append(s.device)
        return out


def place_shares(
    shares: Sequence[float],
    init_intervals: Sequence[float],
    fleet: FleetSpec,
    *,
    # Baseline knob (refs [9]/[10] comparison, §IV-C): preemptive context
    # switching pays capture+store of the running bitstream instead of a
    # fresh II on resume.  PADPS-FR uses the defaults (0, fresh II).
    t_capture: float = 0.0,
    t_store: float = 0.0,
    repay_init: bool = True,
    resilience: int = 0,
) -> PlacementPlan:
    """Simulate the DP-wrap style placement of per-task shares on the fleet.

    Tasks are walked in order (the combo's task order is the paper's task
    order); each device ``j`` is filled from its capacity ``t_slr_j`` and
    charges its own ``t_cfg_j`` (heterogeneous fleets mix FPGA/GPU/CPU
    profiles; the homogeneous case reduces to the paper's Alg 3 exactly);
    splitting carries the remainder of the current task to device ``j+1``.

    ``resilience=k`` additionally requires a *backup* placement: the same
    shares must place on ``fleet.survivors(k)`` — the worst-case fleet
    left by any k device failures — and ``feasible`` becomes the combined
    primary-AND-backup verdict (the backup plan is attached as
    ``plan.backup``).  ``k >= n_f`` can never be survived, so the plan is
    infeasible outright (unless there are no tasks to place).

    This is the *scalar reference oracle* — the block engines in
    :mod:`repro_torch.core.placement_backends` must agree with it
    bit-for-bit.
    """
    n_t = len(shares)
    assert len(init_intervals) == n_t

    scripts = [DeviceScript(device=j) for j in range(fleet.n_f)]
    splits: dict[int, list[tuple[int, float]]] = {}
    executed = [0.0] * n_t

    k = 0  # current task index (paper's sti)
    tsd = 0.0  # share of task k already executed on previous devices
    for j in range(fleet.n_f):
        if k >= n_t:
            break
        t_slr = fleet.t_slr_of(j)
        t_cfg = fleet.t_cfg_of(j)
        c = t_slr
        t = 0.0  # wall position within this device's slice
        script = scripts[j]
        while k < n_t:
            ii = init_intervals[k]
            rem = shares[k] - tsd  # remaining share of task k
            carried = tsd > _EPS
            # Entry cost: fresh config always; carried tasks re-pay II
            # (PADPS-FR) or capture+store of the preempted bitstream
            # (refs [9]/[10] model).
            extra = 0.0
            if carried:
                extra = ii if repay_init else (t_capture + t_store)
            # Start condition (strict): the device must have time to
            # configure + warm up and still produce data.
            if not (c > t_cfg + ii + _EPS):
                break  # task k must start on the next device
            avail = c - t_cfg - extra  # time available for the share
            if avail <= _EPS:
                break
            script.segments.append(Segment("cfg", k, t, t + t_cfg))
            t += t_cfg
            if carried and extra > 0:
                script.segments.append(Segment("init", k, t, t + extra))
                t += extra
            if rem - avail > _EPS:
                # Split: run `avail` worth of share here, carry the rest.
                script.segments.append(Segment("run", k, t, t + avail))
                t += avail
                executed[k] += avail
                splits.setdefault(k, []).append((j, avail))
                tsd += avail
                c = 0.0
                break  # device exhausted; same task continues on j+1
            # Task k fits fully here.
            script.segments.append(Segment("run", k, t, t + rem))
            t += rem
            executed[k] += rem
            if carried:
                splits.setdefault(k, []).append((j, rem))
            c = c - t_cfg - extra - rem
            k += 1
            tsd = 0.0
            # Closure: leftover too small for any further configuration
            # (paper tests against t_cfg + II of the just-placed task).
            if c <= t_cfg + ii + _EPS:
                break
        if t < t_slr - _EPS:
            script.segments.append(Segment("null", -1, t, t_slr))

    feasible = k >= n_t and tsd <= _EPS
    plan_splits = [
        DataSplit(
            task=ti,
            devices=tuple(d for d, _ in parts),
            share_parts=tuple(p for _, p in parts),
        )
        for ti, parts in sorted(splits.items())
    ]
    unplaced = list(range(k, n_t)) if not feasible else []
    if not feasible and tsd > _EPS and k < n_t and k not in unplaced:
        unplaced.insert(0, k)
    plan = PlacementPlan(
        feasible=feasible,
        scripts=scripts,
        splits=plan_splits,
        unplaced=unplaced,
        executed_share=executed,
    )
    if resilience and n_t:
        if resilience >= fleet.n_f:
            plan.feasible = False
        elif plan.feasible:
            plan.backup = place_shares(
                shares,
                init_intervals,
                fleet.survivors(resilience),
                t_capture=t_capture,
                t_store=t_store,
                repay_init=repay_init,
            )
            plan.feasible = plan.backup.feasible
    return plan


def place_combo(
    combo: TaskSetCombo,
    tasks: Sequence[Task],
    fleet: FleetSpec,
    **kw,
) -> PlacementPlan:
    """Place one TSS row (Alg 3 entry point)."""
    iis = [t.init_interval for t in tasks]
    return place_shares(combo.shares, iis, fleet, **kw)
