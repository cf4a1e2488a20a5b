# Scheduler-as-a-service: a live plan maintained across task arrivals,
# exits, device failures and recoveries, with delta replanning
# (repro_torch.core.replan) underneath and a failure-injection simulator
# (repro_torch.service.faultsim) that verifies resilience-mode plans survive.
# Every entry point runs on engine="cuda" unless the caller names another.

from .events import DeviceFailure, DeviceRecovery, Event, TaskArrival, TaskExit
from .faultsim import (
    FaultEventRecord,
    FaultSimResult,
    make_failure_trace,
    power_premium,
    run_fault_injection,
)
from .service import ReplanTelemetry, SchedulerService

__all__ = [
    "DeviceFailure",
    "DeviceRecovery",
    "Event",
    "TaskArrival",
    "TaskExit",
    "ReplanTelemetry",
    "SchedulerService",
    "FaultEventRecord",
    "FaultSimResult",
    "make_failure_trace",
    "run_fault_injection",
    "power_premium",
]
