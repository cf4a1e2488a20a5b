"""Optimizers, LR schedules and gradient compression (torch only)."""

from .optimizers import AdamW, Optimizer, OptState, SGD, Adafactor, clip_by_global_norm, global_norm
from .schedules import constant_lr, cosine_lr, linear_warmup_cosine
from .compression import compress_int8, decompress_int8, ErrorFeedback

__all__ = [
    "AdamW",
    "SGD",
    "Adafactor",
    "Optimizer",
    "OptState",
    "clip_by_global_norm",
    "global_norm",
    "constant_lr",
    "cosine_lr",
    "linear_warmup_cosine",
    "compress_int8",
    "decompress_int8",
    "ErrorFeedback",
]
