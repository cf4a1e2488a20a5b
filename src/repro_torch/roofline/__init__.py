"""Roofline analysis of the dry-run: per-device costs from a trace of the
step (``trace_costs``) or from XLA HLO text (``hlo_costs``)."""

from .analysis import (
    CollectiveStats,
    RooflineResult,
    collective_bytes,
    analyze_compiled,
    roofline_terms,
)

__all__ = [
    "CollectiveStats",
    "RooflineResult",
    "collective_bytes",
    "analyze_compiled",
    "roofline_terms",
]
