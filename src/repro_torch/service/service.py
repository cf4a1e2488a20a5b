"""A long-running scheduler-as-a-service wrapper around PADPS-FR.

The paper's Algs 1-3 solve a *static* instance; :class:`SchedulerService`
keeps a fleet's plan alive across a stream of
:mod:`~repro_torch.service.events` — task arrivals, task exits, device
failures — with three latency tiers per event:

1. **admission filter** — a closed-form eq-7 lower bound (every task at
   its cheapest share) rejects hopeless arrivals without touching the
   combo walk at all;
2. **plan cache** — a task set the service has already solved on the
   current fleet (steady-state churn: a task leaves and comes back) is
   answered from memory;
3. **delta replanner** — everything else goes through
   :meth:`repro_torch.core.scheduler.PADPSFRScheduler.replan`, which
   warm-starts the Alg 1+2 walk from the previous
   :class:`~repro_torch.core.replan.PlanState` and stays bit-identical to a
   cold ``schedule()`` of the same task set.

Beyond the event stream, :meth:`SchedulerService.what_if_many` answers
speculative batched what-ifs — B candidate arrivals scheduled against the
current task set in one fleet-parallel ``schedule_many`` sweep, with no
service state touched.

Every event returns a :class:`ReplanTelemetry` row, so a trace replay
doubles as a latency/provenance log.  Arrivals that turn out infeasible
are *rolled back* — the previous plan keeps serving and the telemetry
records the rejection; device failures are never rolled back (the
device is gone), so an unlucky fleet can end up with ``feasible=False``
telemetry and a degraded (``None``) plan until exits free capacity.

The service runs on ``engine="cuda"`` (the placement sweeps on the card)
unless the caller names another engine; without a CUDA device it raises,
and ``engine="torch"`` runs it on the CPU.  It keeps that engine name
through every rebuild of its scheduler after a failure or recovery, so
its recorded states always match the engine that replans from them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Sequence

from ..core.scheduler import PADPSFRScheduler, ScheduleInstance, ScheduleResult
from ..core.task import DeviceProfile, FleetSpec, Task
from .events import DeviceFailure, DeviceRecovery, Event, TaskArrival, TaskExit

__all__ = ["ReplanTelemetry", "SchedulerService"]

# PlanState.origin -> telemetry path: which replan machinery produced the
# event's result.  Anything the replanner solved fresh (origin "cold")
# reports as "general"; the three warm paths are distinguished so traces
# show *which* event kinds actually reuse work.
_ORIGIN_PATH = {
    "cold": "general",
    "warm_arrival": "warm",
    "warm_exit": "warm_exit",
    "warm_failure": "warm_failure",
}

# Telemetry paths that reused previous work: a solve that skipped the
# fresh branch-and-bound.  (Admission/noop rows never solved at all and
# count separately.)
_WARM_PATHS = ("cache", "warm", "warm_exit", "warm_failure")


@dataclasses.dataclass(frozen=True)
class ReplanTelemetry:
    """What one event cost and what it did to the plan."""

    event: str  # e.g. "arrival(decode-7b)"
    admitted: bool  # did the fleet state actually change?
    # "admission" | "cache" | "warm" | "warm_exit" | "warm_failure"
    # | "general" | "noop"
    path: str
    latency_s: float
    n_tasks: int  # tasks in service after the event
    feasible: bool  # is there a live plan after the event?
    total_power: float  # inf when infeasible / no tasks
    chosen_rank: int  # -1 when infeasible / no tasks
    reason: str = ""  # human detail for rejections / degradations


class SchedulerService:
    """Event-driven scheduling facade with delta replanning.

    ``record_exhaustive=True`` (the default) makes each fresh walk keep
    going past its winner so every TFS row carries a placement verdict —
    the first solve on a big instance costs more, but subsequent arrival
    replans skip dispatch for every recorded reject (the steady-state
    path phase 12 of ``chip_smoke.py`` times on the card).
    Set it to ``False`` to optimise for one-shot latency instead.

    ``SchedulerService(fleet, resilience=k)`` runs every solve in
    resilience mode (the option rides in ``placement_kw``): admitted
    plans are guaranteed to stay placeable after any k device failures,
    and the admission filter tightens to the worst-case survivor fleet's
    eq-7 budget.  The guarantee is verified empirically by
    :mod:`repro_torch.service.faultsim`.

    **Staleness-bounded re-recording.**  Warm replans carry state
    forward, but each hop narrows it (banded removal states, arrival
    chains against an aging root).  After ``max_stale`` consecutive
    warm-path events, or whenever the live state's
    :attr:`~repro_torch.core.replan.PlanState.frontier_coverage` drops below
    ``min_coverage`` (full roots report 1.0; incumbent-banded removal
    states at most 0.5, so the 0.6 default re-roots after every warm
    removal), the service schedules a *background* re-record —
    a full exhaustive ``record_state=True`` solve of the current tasks,
    run after the event's telemetry row is closed (so it never inflates
    event latency), checked bit-identical to the live plan, and swapped
    in as the new root.  ``rerecord_count`` tallies how often the
    policy fired.
    """

    def __init__(
        self,
        fleet: FleetSpec,
        *,
        engine: str = "cuda",
        record_exhaustive: bool = True,
        cache_plans: bool = True,
        max_stale: int = 8,
        min_coverage: float = 0.6,
        **placement_kw,
    ) -> None:
        self.fleet = fleet
        self.engine = engine
        self.record_exhaustive = record_exhaustive
        self.cache_plans = cache_plans
        self.max_stale = int(max_stale)
        self.min_coverage = float(min_coverage)
        self.placement_kw = dict(placement_kw)
        k = self.placement_kw.get("resilience", 0)
        if isinstance(k, bool) or not isinstance(k, int) or k < 0:
            raise ValueError(
                f"resilience must be a non-negative integer, got {k!r}"
            )
        self.resilience = k
        self._sched = PADPSFRScheduler(fleet, engine=engine)
        self._tasks: tuple[Task, ...] = ()
        self._result: ScheduleResult | None = None
        self._cache: dict[tuple, ScheduleResult] = {}
        # LIFO records of failed devices, for DeviceRecovery: the profile
        # and original index for heterogeneous fleets, (None, None) for
        # homogeneous ones (identical devices need no identity).
        self._failed: list[tuple[int, DeviceProfile] | tuple[None, None]] = []
        self.telemetry: list[ReplanTelemetry] = []
        self._stale = 0  # consecutive warm-path events since a fresh root
        self.rerecord_count = 0

    # -- public state ---------------------------------------------------
    @property
    def tasks(self) -> tuple[Task, ...]:
        return self._tasks

    @property
    def plan(self) -> ScheduleResult | None:
        """The live plan (None while the service holds no tasks)."""
        return self._result

    # -- events ---------------------------------------------------------
    def submit(self, task: Task) -> ReplanTelemetry:
        """Admit ``task`` if a feasible plan including it exists."""
        t0 = time.perf_counter()
        if any(t.name == task.name for t in self._tasks):
            return self._log(
                f"arrival({task.name})", False, "admission", t0,
                reason="duplicate task name",
            )
        target = self._tasks + (task,)
        if self.resilience >= self.fleet.n_f:
            # The fleet cannot survive k failures at all; no task set is
            # admissible until devices recover (or exits are free anyway).
            return self._log(
                f"arrival({task.name})", False, "admission", t0,
                reason="resilience exceeds surviving fleet size",
            )
        # Admission bound against the fleet every plan must survive on:
        # the worst-case survivor fleet when resilience is requested.
        bfleet = (
            self.fleet.survivors(self.resilience)
            if self.resilience
            else self.fleet
        )
        lo = sum(min(t.shares(self.fleet.t_slr)) for t in target)
        if lo > bfleet.workable_budget(len(target)) + 1e-9:
            # Even the cheapest variant of every task overshoots eq. 7:
            # the TFS is provably empty, no walk needed.
            return self._log(
                f"arrival({task.name})", False, "admission", t0,
                reason="eq-7 lower bound exceeds fleet budget",
            )
        res, path = self._solve(target)
        if not res.feasible:
            return self._log(
                f"arrival({task.name})", False, path, t0,
                reason="no placeable combo; arrival rolled back",
            )
        self._tasks, self._result = target, res
        return self._log(f"arrival({task.name})", True, path, t0)

    def remove(self, name: str) -> ReplanTelemetry:
        """Release the named task's capacity and replan the remainder."""
        t0 = time.perf_counter()
        if all(t.name != name for t in self._tasks):
            return self._log(
                f"exit({name})", False, "admission", t0,
                reason="unknown task name",
            )
        target = tuple(t for t in self._tasks if t.name != name)
        if not target:
            self._tasks, self._result = (), None
            return self._log(f"exit({name})", True, "noop", t0)
        res, path = self._solve(target)
        # an exit is never rolled back: the task is gone either way.
        self._tasks, self._result = target, res
        return self._log(f"exit({name})", True, path, t0)

    def fail_device(self, device: int = -1) -> ReplanTelemetry:
        """Drop one device from the fleet and replan on what's left.

        ``device`` must be ``-1`` (the last device) or a valid index
        ``0 <= device < n_f``; anything else raises ``ValueError`` — a
        failure report naming a device the fleet does not have is a
        caller bug, not a schedulable event.  Failing the *final* device
        is refused via telemetry (the service must keep one device to
        stay meaningful), not raised: it is a legal trace event that the
        fleet simply cannot absorb.
        """
        t0 = time.perf_counter()
        if self.fleet.n_f == 0:
            raise ValueError("cannot fail a device on an empty fleet")
        if not -1 <= device < self.fleet.n_f:
            raise ValueError(
                f"device index {device} out of range for fleet with "
                f"n_f={self.fleet.n_f} (expected -1 or 0..{self.fleet.n_f - 1})"
            )
        if self.fleet.n_f <= 1:
            return self._log(
                f"device_failure({device})", False, "admission", t0,
                reason="cannot fail the last device",
            )
        idx = device if device >= 0 else self.fleet.n_f - 1
        if self.fleet.is_heterogeneous:
            self._failed.append((idx, self.fleet.devices[idx]))
            profiles = tuple(
                d for j, d in enumerate(self.fleet.devices) if j != idx
            )
            self.fleet = FleetSpec.heterogeneous(profiles, name=self.fleet.name)
        else:
            self._failed.append((None, None))
            self.fleet = dataclasses.replace(self.fleet, n_f=self.fleet.n_f - 1)
        self._sched = PADPSFRScheduler(self.fleet, engine=self.engine)
        if not self._tasks:
            return self._log(f"device_failure({device})", True, "noop", t0)
        res, path = self._solve(self._tasks)
        # never rolled back; the plan may come back infeasible (degraded).
        self._result = res
        return self._log(f"device_failure({device})", True, path, t0)

    def recover_device(self) -> ReplanTelemetry:
        """Restore the most recently failed device (LIFO) and replan.

        Heterogeneous fleets get the exact profile back at its original
        index; homogeneous fleets simply grow by one.  With no failure on
        record the event is refused via telemetry — recovery of a device
        that never failed is a trace inconsistency, not a crash.
        """
        t0 = time.perf_counter()
        if not self._failed:
            return self._log(
                "device_recovery", False, "admission", t0,
                reason="no failed device to recover",
            )
        idx, profile = self._failed.pop()
        if profile is not None:
            devices = list(self.fleet.devices)
            devices.insert(min(idx, len(devices)), profile)
            self.fleet = FleetSpec.heterogeneous(
                tuple(devices), name=self.fleet.name
            )
        else:
            self.fleet = dataclasses.replace(self.fleet, n_f=self.fleet.n_f + 1)
        self._sched = PADPSFRScheduler(self.fleet, engine=self.engine)
        if not self._tasks:
            return self._log("device_recovery", True, "noop", t0)
        res, path = self._solve(self._tasks)
        self._result = res
        return self._log("device_recovery", True, path, t0)

    def replay(self, events: Iterable[Event]) -> list[ReplanTelemetry]:
        """Apply an event trace in order; returns one telemetry row each."""
        out = []
        for ev in events:
            if isinstance(ev, TaskArrival):
                out.append(self.submit(ev.task))
            elif isinstance(ev, TaskExit):
                out.append(self.remove(ev.name))
            elif isinstance(ev, DeviceFailure):
                out.append(self.fail_device(ev.device))
            elif isinstance(ev, DeviceRecovery):
                out.append(self.recover_device())
            else:
                raise TypeError(f"unknown event {ev!r}")
        return out

    # -- batched what-ifs -----------------------------------------------
    def what_if_many(
        self,
        arrivals: Sequence[Task],
        *,
        shard: int | str | None = None,
    ) -> list[ScheduleResult]:
        """Answer "what would admitting each of these cost?" in one sweep.

        Purely speculative: each candidate arrival is scheduled against
        the *current* tasks + that one candidate — B independent
        instances batched through
        :meth:`~repro_torch.core.scheduler.PADPSFRScheduler.schedule_many` —
        and nothing about the service (tasks, plan, cache, telemetry)
        changes.  Returns one :class:`~repro_torch.core.scheduler.ScheduleResult`
        per candidate, in order; an inadmissible candidate simply comes
        back ``feasible=False``.  ``shard`` is forwarded to the batched
        walk, which ignores it (one launch runs on one card).  On
        ``"cuda"`` every round is one launch of the fleet-parallel sweep
        kernel.

        This is the service-side fleet-parallel entry point: a placement
        controller probing "which of these 64 queued jobs fits
        cheapest?" pays one batched walk instead of 64 solo walks.
        """
        instances = [
            ScheduleInstance(tasks=self._tasks + (a,), fleet=self.fleet)
            for a in arrivals
        ]
        return self._sched.schedule_many(
            instances, shard=shard, **self.placement_kw
        )

    # -- internals ------------------------------------------------------
    def _cache_key(self, tasks: Sequence[Task]) -> tuple:
        return (tuple(tasks), self.fleet)

    def _solve(self, target: tuple[Task, ...]) -> tuple[ScheduleResult, str]:
        key = self._cache_key(target)
        if self.cache_plans and key in self._cache:
            return self._cache[key], "cache"
        state = self._result.plan_state if self._result is not None else None
        if state is not None:
            res = self._sched.replan(
                state,
                target,
                record_exhaustive=self.record_exhaustive,
                **self.placement_kw,
            )
            # Every replan tags the state it emits with the path that
            # built it; "cold" covers the general fresh-walk fallback.
            st = res.plan_state
            origin = st.origin if st is not None else "cold"
            path = _ORIGIN_PATH.get(origin, "general")
        else:
            res = self._sched.schedule(
                target,
                record_state=True,
                record_exhaustive=self.record_exhaustive,
                **self.placement_kw,
            )
            path = "general"
        if self.cache_plans and res.feasible:
            self._cache[key] = res
        return res, path

    def _log(
        self,
        event: str,
        admitted: bool,
        path: str,
        t0: float,
        *,
        reason: str = "",
    ) -> ReplanTelemetry:
        res = self._result
        row = ReplanTelemetry(
            event=event,
            admitted=admitted,
            path=path,
            latency_s=time.perf_counter() - t0,
            n_tasks=len(self._tasks),
            feasible=res is not None and res.feasible,
            total_power=res.total_power if res is not None else float("inf"),
            chosen_rank=res.chosen_rank if res is not None else -1,
            reason=reason,
        )
        self.telemetry.append(row)
        if admitted and path in _WARM_PATHS:
            self._stale += 1
        elif admitted and path == "general":
            self._stale = 0
        self._maybe_rerecord(path)
        return row

    def _maybe_rerecord(self, path: str) -> None:
        """Swap in a fresh exhaustive root when the live state is stale.

        Runs *after* the event's telemetry row is closed, so the re-record
        cost never shows up in per-event latency.  The fresh solve must be
        bit-identical to the live plan — anything else means the warm
        paths drifted from cold ``schedule()``, which is a bug worth
        crashing on.
        """
        res = self._result
        if (
            path not in _WARM_PATHS
            or not self._tasks
            or res is None
            or not res.feasible
            or res.plan_state is None
        ):
            return
        st = res.plan_state
        root = st.base if st.base is not None else st
        # A sub-2-task root cannot serve future removals (the exit chain
        # needs a survivor), so a grown service on a tiny root re-roots.
        need = (
            self._stale >= self.max_stale
            or st.frontier_coverage < self.min_coverage
            or len(root.tasks) < 2 <= len(st.tasks)
        )
        if not need:
            return
        fresh = self._sched.schedule(
            self._tasks,
            record_state=True,
            record_exhaustive=True,
            **self.placement_kw,
        )
        if (
            fresh.feasible != res.feasible
            or fresh.total_power != res.total_power
            or fresh.chosen_rank != res.chosen_rank
            or str(fresh.plan) != str(res.plan)
        ):
            raise RuntimeError(
                "re-record produced a different plan than the live warm "
                f"result for {len(self._tasks)} tasks on {self.fleet.name}"
            )
        self._result = fresh
        if self.cache_plans:
            self._cache[self._cache_key(self._tasks)] = fresh
        self._stale = 0
        self.rerecord_count += 1
