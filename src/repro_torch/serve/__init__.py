"""Serving: prefill/decode step factories + batched engine."""

from .engine import ServeConfig, ServeEngine, make_decode_step, make_prefill_step

__all__ = ["ServeEngine", "ServeConfig", "make_prefill_step", "make_decode_step"]
