"""Deterministic synthetic data pipeline (host numpy)."""

from .pipeline import SyntheticLM, make_batch_fn

__all__ = ["SyntheticLM", "make_batch_fn"]
