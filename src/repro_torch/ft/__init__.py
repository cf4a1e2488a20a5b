"""Fault tolerance: health tracking, elastic re-planning, stragglers."""

from .health import FleetHealth, SliceState
from .elastic import ElasticController, ReplanEvent
from .straggler import StragglerDetector

__all__ = [
    "FleetHealth",
    "SliceState",
    "ElasticController",
    "ReplanEvent",
    "StragglerDetector",
]
