"""Elastic re-planning: node loss -> re-run PADPS-FR on the shrunk fleet.

The paper's scheduler is a pure function (fleet, tasks) -> plan, which
makes elasticity a re-plan: when health reports a slice DOWN, the
controller re-schedules the same task set on ``n_f - k`` slices; jobs
restart from their checkpoints (the framework's own mechanism — the
paper likewise re-writes a fresh bitstream + data split rather than
capturing context).  Growing the fleet is the same call with more
slices, typically unlocking lower-power variants.

Every re-plan runs on the controller's ``engine`` (``"cuda"`` unless the
caller names another; ``"torch"`` runs on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from ..core.scheduler import PADPSFRScheduler, ScheduleResult
from ..core.task import FleetSpec, Task

from .health import FleetHealth

__all__ = ["ReplanEvent", "ElasticController"]


@dataclasses.dataclass
class ReplanEvent:
    reason: str
    n_slices: int
    result: ScheduleResult
    dropped_tasks: list[str]


class ElasticController:
    """Owns the current placement plan; re-plans on fleet changes.

    If the full task set no longer fits, tasks are shed lowest-priority
    first (priority = list order) until the plan is feasible — degraded
    but live, never wedged.
    """

    def __init__(self, fleet: FleetSpec, tasks: Sequence[Task], *,
                 health: FleetHealth | None = None, engine: str = "cuda") -> None:
        self.base_fleet = fleet
        self.engine = engine
        self.tasks = list(tasks)
        self.health = health or FleetHealth(fleet.n_f)
        self.events: list[ReplanEvent] = []
        self.current: ScheduleResult | None = None
        self.active_tasks: list[Task] = list(tasks)
        self._last_n_up = self.health.n_up
        self.replan("initial")

    def replan(self, reason: str) -> ReplanEvent:
        n_up = self.health.n_up
        self._last_n_up = n_up
        fleet = self.base_fleet.with_devices(max(n_up, 1))
        dropped: list[str] = []
        tasks = list(self.tasks)
        result = PADPSFRScheduler(fleet, engine=self.engine).schedule(tasks)
        while not result.feasible and len(tasks) > 1:
            shed = tasks.pop()  # lowest priority = last
            dropped.append(shed.name)
            result = PADPSFRScheduler(fleet, engine=self.engine).schedule(tasks)
        self.current = result
        self.active_tasks = tasks
        ev = ReplanEvent(reason=reason, n_slices=fleet.n_f, result=result,
                         dropped_tasks=dropped)
        self.events.append(ev)
        return ev

    # ---- fleet change entry points ----
    def on_slice_down(self, slice_id: int) -> ReplanEvent:
        self.health.mark_down(slice_id)
        return self.replan(f"slice {slice_id} down")

    def on_slice_up(self, slice_id: int) -> ReplanEvent:
        self.health.revive(slice_id)
        return self.replan(f"slice {slice_id} up")

    def poll(self) -> ReplanEvent | None:
        """Heartbeat-driven: re-plan if the up-count changed."""
        self.health.poll()
        if self.health.n_up != self._last_n_up:
            return self.replan("heartbeat change")
        return None
