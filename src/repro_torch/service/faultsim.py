"""Failure-injection simulator: does a k-resilient plan really survive?

The resilience mode (``PADPSFRScheduler.schedule(..., resilience=k)`` /
``SchedulerService(resilience=k)``) *proves* its guarantee analytically —
every accepted combo passes a second placement sweep on the worst-case
survivor fleet.  This module closes the loop empirically: it builds
deterministic seeded traces of :class:`~repro_torch.service.events.DeviceFailure`
(and optional :class:`~repro_torch.service.events.DeviceRecovery`) events,
replays them through a live :class:`~repro_torch.service.SchedulerService`, and
counts **replan-window deadline misses**.

The miss model is the service's own failure semantics: when a device
dies, the *serving* plan keeps running until the replanner answers, and
only switches over when a replan succeeds.  If the serving combo still
places on the surviving fleet (checked against the scalar oracle,
:func:`repro_torch.core.placement.place_combo`), every task's share fits a
slice and no deadline is missed; if it does not, every task misses one
deadline per period that elapses inside the *measured* replan window —
the failure event's own telemetry latency, which the warm-removal path
(``path="warm_failure"``) keeps far below one period, so in practice
each task is charged ``max(1, ceil(latency / period))`` = one miss.

What the simulator demonstrates (asserted in
``tests/test_torch_faultsim_ft.py`` and on the card by phase 12 of
``chip_smoke.py``):

* a ``resilience=k`` plan replayed under **any** k seeded failures
  records **zero** replan-window misses — the worst-case-survivor check
  covers every actual k-subset on homogeneous fleets (all k-subsets are
  equivalent) and the documented deterministic adversary on
  heterogeneous ones;
* the same trace against a ``resilience=0`` service on a crafted
  instance records misses — the guarantee is not vacuous;
* the price of the guarantee is the **power premium**
  (:func:`power_premium`): the k-resilient winner's total power over the
  unconstrained winner's.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core.placement import place_combo
from ..core.task import FleetSpec, Task
from .events import DeviceFailure, DeviceRecovery, Event
from .service import SchedulerService

__all__ = [
    "FaultEventRecord",
    "FaultSimResult",
    "make_failure_trace",
    "run_fault_injection",
    "power_premium",
]


@dataclasses.dataclass(frozen=True)
class FaultEventRecord:
    """One injected event and what it did to the live plan."""

    step: int
    event: str  # the event's describe() string
    n_f_after: int  # surviving fleet size after the event
    plan_survived: bool  # serving combo still places on the new fleet
    misses: int  # replan-window deadline misses charged to this event
    replanned_feasible: bool  # did the service find a plan afterwards?
    total_power: float  # live plan power after the event (inf if none)


@dataclasses.dataclass
class FaultSimResult:
    """Outcome of one seeded trace replayed through the service."""

    resilience: int
    seed: int
    n_tasks: int
    n_failures: int
    records: list[FaultEventRecord]
    initial_power: float

    @property
    def total_misses(self) -> int:
        return sum(r.misses for r in self.records)

    @property
    def survived(self) -> bool:
        """True when no injected failure caused a replan-window miss."""
        return self.total_misses == 0


def make_failure_trace(
    n_f: int,
    n_failures: int,
    *,
    seed: int = 0,
    recover: bool = False,
) -> list[Event]:
    """Deterministic seeded failure (and optional recovery) trace.

    Each failure targets a uniformly drawn valid index of the fleet as it
    stands at that point in the trace (``n_f``, then ``n_f - 1``, ...),
    so replays are valid on homogeneous and heterogeneous fleets alike.
    With ``recover=True`` the trace heals every failure afterwards (LIFO,
    matching :meth:`~repro_torch.service.SchedulerService.recover_device`), so
    a replay ends on the original fleet size.
    """
    if n_failures >= n_f:
        raise ValueError(
            f"cannot fail {n_failures} of {n_f} devices and keep a fleet"
        )
    rng = np.random.default_rng(seed)
    events: list[Event] = []
    for i in range(n_failures):
        events.append(DeviceFailure(device=int(rng.integers(0, n_f - i))))
    if recover:
        events.extend(DeviceRecovery() for _ in range(n_failures))
    return events


def run_fault_injection(
    fleet: FleetSpec,
    tasks: Sequence[Task],
    *,
    resilience: int = 0,
    n_failures: int = 1,
    seed: int = 0,
    recover: bool = False,
    engine: str = "cuda",
) -> FaultSimResult:
    """Schedule ``tasks`` at the given resilience, then inject failures.

    Builds a :class:`~repro_torch.service.SchedulerService` with
    ``resilience=k``, submits every task (raises if any is rejected —
    the caller's instance must be admissible at the requested k; an
    inadmissible instance proves nothing about survival), replays the
    seeded trace, and charges replan-window misses per the module's miss
    model.  Returns the full per-event record.
    """
    svc = SchedulerService(fleet, engine=engine, resilience=resilience)
    for t in tasks:
        row = svc.submit(t)
        if not row.admitted:
            raise ValueError(
                f"task {t.name!r} rejected at resilience={resilience}: "
                f"{row.reason}"
            )
    assert svc.plan is not None
    initial_power = float(svc.plan.total_power)
    trace = make_failure_trace(
        fleet.n_f, n_failures, seed=seed, recover=recover
    )
    # The combo actually serving traffic.  It only switches when a replan
    # *succeeds* — a real deployment keeps running the old plan while the
    # replanner comes up empty (e.g. a k=2 service on 3 survivors cannot
    # re-prove 2-fault tolerance, but the original k=2 plan still places).
    serving = svc.plan
    records: list[FaultEventRecord] = []
    for step, ev in enumerate(trace):
        pre_fleet = svc.fleet
        if isinstance(ev, DeviceFailure):
            svc.fail_device(ev.device)
        else:
            svc.recover_device()
        if isinstance(ev, DeviceFailure) and svc.fleet.n_f == pre_fleet.n_f:
            # Refused (last device): nothing changed, nothing to miss.
            survived, misses = True, 0
        elif isinstance(ev, DeviceFailure):
            # The replan window: the serving combo keeps running on the
            # surviving fleet until the replanner answers.  The scalar
            # oracle is the ground truth for whether those slices still
            # meet every deadline; if not, each task misses once per
            # period elapsed inside the event's measured replan latency.
            plan = place_combo(serving.combo, svc.tasks, svc.fleet)
            survived = bool(plan.feasible)
            if survived:
                misses = 0
            else:
                window = svc.telemetry[-1].latency_s
                misses = sum(
                    max(1, int(np.ceil(window / t.period)))
                    for t in svc.tasks
                )
        else:
            # Recoveries only add capacity; a plan that served the
            # smaller fleet serves the larger one unchanged.
            survived, misses = True, 0
        post = svc.plan
        if post is not None and post.feasible:
            serving = post  # the replanner answered: switch over
        records.append(
            FaultEventRecord(
                step=step,
                event=ev.describe(),
                n_f_after=svc.fleet.n_f,
                plan_survived=survived,
                misses=misses,
                replanned_feasible=post is not None and post.feasible,
                total_power=(
                    float(post.total_power) if post is not None else float("inf")
                ),
            )
        )
    return FaultSimResult(
        resilience=resilience,
        seed=seed,
        n_tasks=len(tasks),
        n_failures=n_failures,
        records=records,
        initial_power=initial_power,
    )


def power_premium(
    fleet: FleetSpec,
    tasks: Sequence[Task],
    ks: Sequence[int] = (0, 1, 2),
    *,
    engine: str = "cuda",
) -> dict[int, dict]:
    """The cost of the guarantee: total power at each resilience level.

    Schedules the same instance once per ``k`` and reports each level's
    winning power plus its premium over the ``k=0`` baseline (``None``
    when a level is infeasible).
    """
    from ..core.scheduler import PADPSFRScheduler

    sched = PADPSFRScheduler(fleet, engine=engine)
    out: dict[int, dict] = {}
    base: float | None = None
    for k in ks:
        res = sched.schedule(tuple(tasks), resilience=int(k))
        power = float(res.total_power) if res.feasible else None
        if k == 0:
            base = power
        if power is None or base is None:
            premium = None
        elif base > 0.0:
            premium = (power - base) / base * 100.0
        else:
            # zero-power k=0 baseline: any k-resilient plan is pure premium,
            # but there is no ratio to report — pin it at 0.0
            premium = 0.0
        out[int(k)] = {
            "feasible": bool(res.feasible),
            "power": power,
            "premium_pct": premium,
            "chosen_rank": int(res.chosen_rank),
        }
    return out
