"""Per-device cost extraction from a torch program, as it runs or traces.

The port's counterpart of the HLO walker (``hlo_costs``): where the JAX
package compiles a step and walks the partitioned HLO module, the port
runs the step once, on DTensors over a ``DeviceMesh`` (on ``meta`` local
shards nothing is computed or allocated), inside
``count_costs()``, a ``TorchDispatchMode`` that records every aten op that
reaches it.  It counts **per device**: an op on DTensors is handed on to
DTensor (the mode returns ``NotImplemented`` for it), which runs the op on
its local shards and redistributes; those local ops and collectives come
back through the mode and are counted.  The ops DTensor runs on fake
tensors of the global shapes to propagate shapes
(``ShardingPropagator._propagate_tensor_meta_non_cached``) are not the
program's work: the mode is paused around them.  A program on plain
tensors counts as one device.

* ``dot_flops``   — matmul, bmm, baddbmm (einsum lowers to these) and SDPA,
                    as ``torch.utils.flop_counter`` counts them,
* ``ew_flops``    — 1 FLOP per output element for the aten counterparts of
                    the HLO walker's elementwise / reduce ops,
* ``bytes``       — operand + result bytes of every compute op (views,
                    ``detach``, allocation without a write and collective
                    waits are free, as the walker's ``_FREE_OPS`` are),
* ``coll_bytes`` / ``coll_counts`` — operand bytes and counts of the
                    functional collectives, under the walker's op names,
* ``peak_bytes``  — the peak of live bytes of the storages the program
                    created (its temporaries and outputs), which stands in
                    for XLA's ``temp_size_in_bytes``.

A move of a sharded dim to another dim on one mesh dim (DTensor's
``shard_dim_alltoall``) counts as one all-to-all of its input's bytes,
whatever the process group runs: on a CPU mesh (gloo, the fake world)
DTensor falls back to an all-gather and a chunk, which are not counted and
whose gathered tensor is not live; only the local output is.

``count_costs()`` runs a ``CostMode``; ``counting(mode)`` runs a subclass
of it (one that breaks the counts down, say) with the same patches.

There are no loops to scale: eager torch runs a layer loop as a loop, so
every layer's ops pass through the mode.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .hlo_costs import HloCosts

__all__ = ["CostMode", "TraceCosts", "count_costs", "counting"]

# aten counterparts of the HLO walker's _EW_OPS: ~1 flop per output element
_EW_NAMES = {
    "add", "sub", "mul", "div", "maximum", "minimum", "abs", "neg", "exp", "expm1",
    "log", "log1p", "tanh", "sigmoid", "sqrt", "rsqrt", "pow", "cos", "sin", "floor",
    "ceil", "round", "remainder", "fmod", "atan2", "erf", "reciprocal", "sign",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "clamp", "clamp_min", "clamp_max",
    "logical_and", "logical_or", "logical_xor", "logical_not", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "bitwise_left_shift",
    "bitwise_right_shift", "__lshift__", "__rshift__",
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp", "cumsum",
    "_softmax", "_log_softmax", "silu", "gelu", "softplus", "rsub", "lerp",
    "addcmul", "addcdiv", "silu_backward", "gelu_backward",
    "sigmoid_backward", "tanh_backward", "threshold_backward", "softplus_backward",
    "_softmax_backward_data", "_log_softmax_backward_data",
}

# functional collectives -> the HLO walker's names
_COLL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}

# ops that move no data: allocation without a write, device queries,
# collective completion (its bytes are the collective's)
_FREE_NAMES = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach",
    "lift_fresh", "lift_fresh_copy", "wait_tensor", "device", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "is_same_size", "_local_scalar_dense",
}


# ops whose output aliases their input: a functional collective's result
# wrapped for autograd
_ALIAS_NAMES = {"_wrap_tensor_autograd"}


def _name(func) -> str:
    name = func._overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.startswith("_") else name


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class TraceCosts(HloCosts):
    peak_bytes: float = 0.0
    arg_bytes: float = 0.0  # the step's inputs a device, set by the caller
    out_bytes: float = 0.0  # the step's outputs a device, set by the caller


class CostMode(TorchDispatchMode):
    """The counter: fills ``costs`` from every op that reaches it and,
    through ``alltoall``, from DTensor's all-to-alls.  ``seen`` maps each
    live storage it counts (``id``) to its bytes."""

    def __init__(self, costs: TraceCosts) -> None:
        super().__init__()
        self.costs = costs
        self.live = 0
        self.seen: dict[int, int] = {}  # id(storage) -> bytes, while it lives
        self.paused = 0

    def _track(self, outs: list, nbytes: int | None = None) -> None:
        """Count the storages of ``outs`` live until they die (each at
        ``nbytes`` if given, else at its storage's size)."""
        for t in outs:
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = id(st)
            if key in self.seen:
                continue
            n = st.nbytes() if nbytes is None else nbytes
            self.seen[key] = n
            self.live += n
            weakref.finalize(st, self._free, key)
        self.costs.peak_bytes = max(self.costs.peak_bytes, float(self.live))

    def _free(self, key: int) -> None:
        self.live -= self.seen.pop(key, 0)

    def _collective(self, op: str, ins: list, outs: list) -> None:
        c = self.costs
        b = sum(_nbytes(t) for t in ins)
        c.coll_bytes[op] += b
        c.coll_counts[op] += 1
        c.bytes += b + sum(_nbytes(t) for t in outs)

    def alltoall(self, fn, input, *args):
        """One all-to-all of ``input``'s bytes for ``fn`` (DTensor's
        ``shard_dim_alltoall``), whatever ``fn`` runs; only its output
        lives on."""
        if self.paused:
            return fn(input, *args)
        self.paused += 1
        try:
            out = fn(input, *args)
        finally:
            self.paused -= 1
        self._collective("all-to-all", [input], [out])
        self._track([out], _nbytes(out))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs the local ops, which come back here
        out = func(*args, **kwargs)
        if self.paused:
            return out  # DTensor's shape propagation, not the program's work
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        name = _name(func)
        c = self.costs
        packet = func._overloadpacket
        if name in _COLL:
            self._collective(_COLL[name], ins, outs)
        elif name in _FREE_NAMES or name in _ALIAS_NAMES or _is_view(func):
            pass
        elif packet in flop_registry:
            c.dot_flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
            c.bytes += sum(_nbytes(t) for t in ins + outs)
        else:
            if name in _EW_NAMES:
                c.ew_flops += sum(t.numel() for t in outs)
            c.bytes += sum(_nbytes(t) for t in ins + outs)
        if not (_is_view(func) or name in _ALIAS_NAMES):
            self._track(outs)
        return out


@contextlib.contextmanager
def count_costs():
    """Record the per-device costs of the ops run inside; yields the
    ``TraceCosts`` it fills."""
    costs = TraceCosts()
    with counting(CostMode(costs)):
        yield costs


@contextlib.contextmanager
def counting(mode: CostMode):
    """Run the ops inside under ``mode``, with DTensor's shape propagation
    paused out of the count and its all-to-alls handed to
    ``mode.alltoall``."""
    from torch.distributed.tensor import _collective_utils, placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    propagate = ShardingPropagator._propagate_tensor_meta_non_cached
    alltoall = _collective_utils.shard_dim_alltoall
    # placement_types imports the function by name: patch it there too
    users = [m for m in (_collective_utils, placement_types)
             if getattr(m, "shard_dim_alltoall", None) is alltoall]

    def paused(self, *args, **kwargs):
        mode.paused += 1
        try:
            return propagate(self, *args, **kwargs)
        finally:
            mode.paused -= 1

    def counted_alltoall(input, *args):
        return mode.alltoall(alltoall, input, *args)

    ShardingPropagator._propagate_tensor_meta_non_cached = paused
    for m in users:
        m.shard_dim_alltoall = counted_alltoall
    try:
        with mode:
            yield mode
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        for m in users:
            m.shard_dim_alltoall = alltoall
