"""Production meshes, as ``DeviceMesh``es over the default process group.

``make_production_mesh()`` is a FUNCTION (importing this module never
touches process-group state):

* single-pod:  (16, 16)    axes ('data', 'model')      — 256 devices
* multi-pod:   (2, 16, 16) axes ('pod', 'data', 'model') — 512 devices

The ``pod`` axis is an outer data-parallel axis: batch shards over
('pod', 'data'); cross-pod traffic is only the gradient reduction in
training and nothing in serving.

A mesh needs a process group of at least its size.  With one card, the
production meshes exist only in ``fake_world(n)``: torch's fake backend,
one process standing for rank 0 of ``n``, whose collectives move nothing.
On ``meta`` local shards a program then traces on the mesh with no device
and no allocation, which is what the dry-run does.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_production_mesh", "make_mesh", "SINGLE_POD", "MULTI_POD"]

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    """A mesh over the first prod(shape) ranks of the default process group
    (tests use (1,2)/(2,2,2)-sized variants): of "cuda" devices on an NCCL
    group, "cpu" ones otherwise (the fake backend's too)."""
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"mesh {shape} needs a process group of {n} ranks; none is "
                           "initialized (use fake_world(n) to trace without devices)")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}, have {world}")
    return DeviceMesh(_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return make_mesh(shape, axes)


@contextlib.contextmanager
def fake_world(n: int):
    """The default process group as rank 0 of ``n`` on torch's fake backend,
    destroyed on exit."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "fake_world needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this torch lacks"
        ) from e
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
