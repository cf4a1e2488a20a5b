"""Pluggable Alg-2 block-placement backends.

The scheduler's hot path — *is this TFS row placeable?* for a whole block
of power-sorted rows — dispatches through a registry of interchangeable
engines (see :mod:`.base` for the contract and how to register new ones):

* ``"cuda"``   — the hand-written CUDA sweep kernel
  (:mod:`repro_torch.kernels.placement_step`) on the card, with pinned
  asynchronous copies and double-buffered dispatch (lazy: registered on
  first lookup; raises without a CUDA device);
* ``"torch"``  — the same sweep in plain torch ops on CPU tensors;
* ``"scalar"`` — the exact Alg-2/Alg-3 oracle, one row at a time.
"""

from .base import (
    BatchPlacement,
    InstanceBatch,
    PlacementBackend,
    PlacementOptions,
    available_backends,
    backend_names,
    dispatch_instance_blocks,
    get_backend,
    place_instance_blocks,
    prepare_block,
    register_backend,
    resolve_engine,
    survivor_batch_tables,
    survivor_tables,
)

# Importing the CPU backends registers them; "cuda" is registered lazily by
# the registry (see base._LAZY_BACKENDS).
from . import scalar_backend as _scalar_backend  # noqa: F401
from . import torch_backend as _torch_backend  # noqa: F401

__all__ = [
    "BatchPlacement",
    "InstanceBatch",
    "PlacementBackend",
    "PlacementOptions",
    "available_backends",
    "backend_names",
    "dispatch_instance_blocks",
    "get_backend",
    "place_instance_blocks",
    "prepare_block",
    "register_backend",
    "resolve_engine",
    "survivor_batch_tables",
    "survivor_tables",
]
