"""Event vocabulary for the scheduling service.

A data-center fleet is not a one-shot instance: tasks arrive, tasks
finish, devices fail (the scheduler-lifecycle framing — admit / place /
reconfigure — of the energy-efficiency survey arXiv:2309.12884).  The
service consumes a stream of these events and keeps a live plan; each
event is a plain frozen dataclass so traces can be built, logged and
replayed deterministically (``SchedulerService.replay``).

Every event kind has a warm replanning path — arrivals cross-product
against the recorded root (telemetry ``path="warm"``), exits project
the recorded rows onto the surviving task axes (``"warm_exit"``), and
device failures re-rank them against the shrunken fleet
(``"warm_failure"``) — so a long mixed trace mostly reuses one
recording (phase 12 of ``chip_smoke.py`` measures the hit rate on the
card).
"""

from __future__ import annotations

import dataclasses
from typing import Union

from ..core.task import Task

__all__ = ["TaskArrival", "TaskExit", "DeviceFailure", "DeviceRecovery", "Event"]


@dataclasses.dataclass(frozen=True)
class TaskArrival:
    """A new periodic task asks to join the fleet."""

    task: Task

    def describe(self) -> str:
        return f"arrival({self.task.name})"


@dataclasses.dataclass(frozen=True)
class TaskExit:
    """A running task leaves (completed or cancelled), freeing capacity."""

    name: str

    def describe(self) -> str:
        return f"exit({self.name})"


@dataclasses.dataclass(frozen=True)
class DeviceFailure:
    """A fleet device goes dark.  ``device`` indexes the failed device;
    ``-1`` means the last one (the only distinguishable choice on a
    homogeneous fleet)."""

    device: int = -1

    def describe(self) -> str:
        return f"device_failure({self.device})"


@dataclasses.dataclass(frozen=True)
class DeviceRecovery:
    """The most recently failed device comes back (repair / restart).

    Recovery is LIFO: the service keeps a stack of failed-device records
    and a recovery pops the newest — enough to express any
    fail-k-then-heal trace the fault-injection simulator replays, without
    needing stable device identities on homogeneous fleets."""

    def describe(self) -> str:
        return "device_recovery"


Event = Union[TaskArrival, TaskExit, DeviceFailure, DeviceRecovery]
