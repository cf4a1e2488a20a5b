# PADPS-FR — power-aware DP-fair/DP-wrap scheduling of periodic hardware
# tasks on accelerator fleets (Algs 1-3), with the Alg-2 placement sweep on
# a CUDA device, plus the baselines and metrics it is evaluated against.

from .task import (
    DeviceProfile,
    FleetSpec,
    Task,
    TaskSetCombo,
    TaskVariant,
    combo_count,
    validate_tasks,
    worst_case_survivor_indices,
)
from .feasibility import (
    BlockEnumerator,
    ComboBlock,
    FeasibilityResult,
    config_overhead_lower_bound,
    iter_feasible_pruned,
    iter_feasible_pruned_blocks,
    outer_sum,
    search_feasible,
)
from .placement import DataSplit, DeviceScript, PlacementPlan, Segment, place_combo, place_shares
from .placement_backends import (
    BatchPlacement,
    InstanceBatch,
    PlacementBackend,
    PlacementOptions,
    available_backends,
    backend_names,
    get_backend,
    register_backend,
    resolve_engine,
)
from .placement_batched import place_batch, place_combos_batch
from .replan import PlanState
from .scheduler import (
    PADPSFRScheduler,
    ScheduleInstance,
    ScheduleResult,
    WalkStats,
    block_ramp,
    select_lowest_power,
    select_lowest_power_batched,
)
from .metrics import SweepPoint, avg_task_weight, sweep_fleet, system_workload, trr
from .baselines import (
    GreedyResult,
    count_placeable,
    edf_schedule,
    erfair_context_switches,
    llf_schedule,
    preemptive_dpfair_schedule,
)
from .gantt import plan_rows, render_gantt

__all__ = [
    "DeviceProfile",
    "FleetSpec",
    "Task",
    "TaskSetCombo",
    "TaskVariant",
    "combo_count",
    "validate_tasks",
    "worst_case_survivor_indices",
    "BlockEnumerator",
    "ComboBlock",
    "FeasibilityResult",
    "config_overhead_lower_bound",
    "iter_feasible_pruned",
    "iter_feasible_pruned_blocks",
    "outer_sum",
    "search_feasible",
    "DataSplit",
    "DeviceScript",
    "PlacementPlan",
    "Segment",
    "place_combo",
    "place_shares",
    "BatchPlacement",
    "InstanceBatch",
    "PlacementBackend",
    "PlacementOptions",
    "available_backends",
    "backend_names",
    "get_backend",
    "register_backend",
    "resolve_engine",
    "place_batch",
    "place_combos_batch",
    "PlanState",
    "PADPSFRScheduler",
    "ScheduleInstance",
    "ScheduleResult",
    "WalkStats",
    "block_ramp",
    "select_lowest_power",
    "select_lowest_power_batched",
    "SweepPoint",
    "avg_task_weight",
    "sweep_fleet",
    "system_workload",
    "trr",
    "GreedyResult",
    "count_placeable",
    "edf_schedule",
    "erfair_context_switches",
    "llf_schedule",
    "preemptive_dpfair_schedule",
    "plan_rows",
    "render_gantt",
]
