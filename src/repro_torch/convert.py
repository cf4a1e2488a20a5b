"""Build this package's types from the reference's: scheduler instances by
duck typing, model parameters and decode states from numpy arrays.

``task_from`` / ``tasks_from`` / ``fleet_from`` / ``instance_from`` /
``instances_from`` read any object carrying the reference field names
(``Task``: name, period, data, init_interval, variants; ``TaskVariant``:
cu, throughput, power, program; ``FleetSpec``: n_f, t_slr, t_cfg, name,
devices; ``DeviceProfile``: t_slr, t_cfg, klass; ``ScheduleInstance``:
tasks, fleet) by duck typing, so two implementations can be fed the same instance field
by field.  Floats pass through unchanged, so shares and powers stay
bit-identical.

``params_from`` / ``state_from`` turn the JAX package's parameter tree and
decode state, handed over as numpy arrays (``jax.tree.map(np.asarray,
params)``; a KV cache is a ``(k, v)`` pair, an enc-dec cache a dict of
two such pairs, an SSM or hybrid state a dict), into torch tensors with
the same names and structure, every family's (the MoE blocks' router and
expert stacks, the enc-dec model's ``enc_blocks`` / ``dec_blocks``), so
the port can run on the reference's weights and continue from its
prefill.  ``train_state_from`` does the same for a train state (params,
optimizer moments, step, error-feedback residual), so both packages can
continue training from one state.  A bfloat16 array (the ``ml_dtypes``
type that jax hands to numpy) keeps its bits.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch

from .core.scheduler import ScheduleInstance
from .core.task import DeviceProfile, FleetSpec, Task, TaskVariant
from .train.step import TrainState

__all__ = [
    "task_from", "tasks_from", "fleet_from", "instance_from", "instances_from",
    "params_from", "state_from", "train_state_from",
]


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


def _tensor(arr, device, dtype) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":  # torch cannot read that type: carry the bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype)


def _tree_from(node: Any, device, dtype):
    if isinstance(node, dict):
        return {k: _tree_from(v, device, dtype) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(_tree_from(v, device, dtype) for v in node)
    return _tensor(node, device, dtype)


def params_from(tree: dict, device: torch.device | str, dtype: torch.dtype | None = None) -> dict:
    """A parameter tree of numpy arrays -> the same tree of tensors on
    ``device`` (types kept unless ``dtype`` is given), name for name."""
    return _tree_from(tree, device, dtype)


def state_from(state: Any, device: torch.device | str) -> Any:
    """A decode state of numpy arrays -> the same structure of tensors on
    ``device``, types kept.  The structure is a transformer's ``(k, v)``
    cache of ``(L, B, T, K, hd)`` (dense, MoE and VLM), an enc-dec model's
    ``{"self": (k, v), "cross": (k, v)}``, an SSM's dict of ``conv_x`` / ``conv_B``
    / ``conv_C`` / ``ssm``, or a hybrid's nested dict
    ``{"super": {"0": {"conv", "h"}, "1": ..., "2": {"ck", "cv"}}, "rest":
    {...}}`` (each leaf stacked ``(n_super, ...)`` under ``super`` and
    ``(1, ...)`` under ``rest``)."""
    return _tree_from(state, device, None)


def train_state_from(state: Any, device: torch.device | str) -> TrainState:
    """The JAX package's ``TrainState`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``), read by its field names -> the
    port's, on ``device``, types kept: ``params``; ``opt_state`` (AdamW's
    ``m`` / ``v``, SGD's ``mom`` or Adafactor's ``f``, trees of the
    params' names); ``step`` (0-d int32); ``ef_residual`` (None without
    compression)."""
    ef = state.ef_residual
    return TrainState(
        params=_tree_from(state.params, device, None),
        opt_state=_tree_from(state.opt_state, device, None),
        step=_tensor(state.step, device, torch.int32),
        ef_residual=None if ef is None else _tree_from(ef, device, None),
    )
