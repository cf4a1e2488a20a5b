"""Build this package's task, fleet and instance types from look-alike objects.

``task_from`` / ``tasks_from`` / ``fleet_from`` / ``instance_from`` /
``instances_from`` read any object carrying the reference field names
(``Task``: name, period, data, init_interval, variants; ``TaskVariant``:
cu, throughput, power, program; ``FleetSpec``: n_f, t_slr, t_cfg, name,
devices; ``DeviceProfile``: t_slr, t_cfg, klass; ``ScheduleInstance``:
tasks, fleet) by duck typing, so two implementations can be fed the same instance field
by field.  Floats pass through unchanged, so shares and powers stay
bit-identical.
"""

from __future__ import annotations

from typing import Iterable

from .core.scheduler import ScheduleInstance
from .core.task import DeviceProfile, FleetSpec, Task, TaskVariant

__all__ = ["task_from", "tasks_from", "fleet_from", "instance_from", "instances_from"]


def task_from(obj) -> Task:
    return Task(
        name=obj.name,
        period=obj.period,
        data=obj.data,
        init_interval=obj.init_interval,
        variants=tuple(
            TaskVariant(
                cu=v.cu,
                throughput=v.throughput,
                power=v.power,
                program=getattr(v, "program", ""),
            )
            for v in obj.variants
        ),
    )


def tasks_from(objs: Iterable) -> tuple[Task, ...]:
    return tuple(task_from(o) for o in objs)


def fleet_from(obj) -> FleetSpec:
    return FleetSpec(
        n_f=obj.n_f,
        t_slr=obj.t_slr,
        t_cfg=obj.t_cfg,
        name=getattr(obj, "name", "fleet"),
        devices=tuple(
            DeviceProfile(t_slr=d.t_slr, t_cfg=d.t_cfg, klass=getattr(d, "klass", "fpga"))
            for d in getattr(obj, "devices", ())
        ),
    )


def instance_from(obj) -> ScheduleInstance:
    """A ``ScheduleInstance``; a ``fleet`` of ``None`` stays ``None`` (the
    scheduler's own fleet)."""
    fleet = getattr(obj, "fleet", None)
    return ScheduleInstance(
        tasks=tasks_from(obj.tasks),
        fleet=None if fleet is None else fleet_from(fleet),
    )


def instances_from(objs: Iterable) -> list[ScheduleInstance]:
    return [instance_from(o) for o in objs]
