"""Logical-axis sharding rules (MaxText-style), as DTensor placements.

Models annotate every parameter and input dimension with a *logical*
axis name; a rules table maps logical axes to mesh axes.  The placements
of a tensor on a ``DeviceMesh`` are derived from the table, never written
per model, so a change of sharding strategy is a one-line rule edit that
applies to every architecture at once.

Resolution is shape-aware, as the JAX package's is: a mesh axis that does
not evenly divide its dimension, or that an earlier dimension of the same
tensor already took, is dropped (that dimension stays replicated).  E.g.
seamless' vocab 256206 does not divide by 16 and falls back to replicated.

``resolve_spec`` returns the nested tuple a ``PartitionSpec`` holds (per
tensor dim: ``None``, a mesh-axis name or a tuple of names, trailing
``None``s trimmed); ``placements`` turns it into DTensor placements (per
mesh dim: ``Shard(tensor_dim)`` or ``Replicate()``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

from .._tree import tree_map

__all__ = [
    "ShardingRules",
    "TP_DP_RULES",
    "FSDP_TP_RULES",
    "PRESETS",
    "resolve_spec",
    "tree_shardings",
    "batch_axes",
]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis -> candidate mesh axes (applied left to right)."""

    name: str
    table: Mapping[str, tuple[str, ...]]

    def lookup(self, logical: str | None) -> tuple[str, ...]:
        if logical is None:
            return ()
        return tuple(self.table.get(logical, ()))


# Baseline: plain TP over 'model' + DP batch over ('pod','data').
# Weights replicated across the data axis.
TP_DP_RULES = ShardingRules(
    "tp_dp",
    {
        "batch": ("pod", "data"),
        "heads": ("model",),
        "kv": ("model",),
        "mlp": ("model",),
        "vocab": ("model",),
        "expert": ("model",),
        "state": ("model",),
        "embed": (),
        "layers": (),
        "conv": (),
        "seq": (),
        "act_seq": (),
    },
)

# 2-D weight sharding: FSDP over 'data' on the embed dimension on top of
# TP.  Params and optimizer memory drop by the data-axis size; weights are
# all-gathered on use (ZeRO-3 semantics).
FSDP_TP_RULES = ShardingRules(
    "fsdp_tp",
    {
        "batch": ("pod", "data"),
        "heads": ("model",),
        "kv": ("model",),
        "mlp": ("model",),
        "vocab": ("model",),
        "expert": ("model",),
        "state": ("model",),
        "embed": ("data",),
        "layers": (),
        "conv": (),
        "seq": (),
        "act_seq": (),
    },
)

# + Megatron-style sequence parallelism: the residual stream shards its
# sequence dim over 'model' between blocks; it is all-gathered before
# qkv / mlp and reduce-scattered after.
FSDP_TP_SP_RULES = ShardingRules(
    "fsdp_tp_sp",
    {
        "batch": ("pod", "data"),
        "heads": ("model",),
        "kv": ("model",),
        "mlp": ("model",),
        "vocab": ("model",),
        "expert": ("model",),
        "state": ("model",),
        "embed": ("data",),
        "layers": (),
        "conv": (),
        "seq": (),
        "act_seq": ("model",),
    },
)

# Sequence-parallel variant for long-context serving: KV-cache time axis
# sharded over 'model' (kv heads too few to fill the axis on GQA archs).
SP_SERVE_RULES = ShardingRules(
    "sp_serve",
    {
        "batch": ("pod", "data"),
        "heads": ("model",),
        "kv": (),
        "mlp": ("model",),
        "vocab": ("model",),
        "expert": ("model",),
        "state": ("model",),
        "embed": ("data",),
        "layers": (),
        "conv": (),
        "seq": ("model",),
        "act_seq": (),
    },
)

PRESETS: dict[str, ShardingRules] = {
    r.name: r
    for r in (TP_DP_RULES, FSDP_TP_RULES, FSDP_TP_SP_RULES, SP_SERVE_RULES)
}


def mesh_sizes(mesh: Any) -> dict[str, int]:
    """Mesh axis name -> size, for a ``DeviceMesh`` or any object with
    ``mesh_dim_names`` and ``shape``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape), strict=True))


def resolve_spec(
    axes: Sequence[str | None],
    shape: Sequence[int],
    mesh: Any,
    rules: ShardingRules,
) -> tuple:
    """Logical axes + shape -> the PartitionSpec tuple, dropping
    non-dividing axes."""
    used: set[str] = set()
    parts: list[Any] = []
    sizes = mesh_sizes(mesh)
    for dim, logical in zip(shape, axes, strict=True):
        cand = [a for a in rules.lookup(logical) if a in sizes and a not in used]
        picked: list[str] = []
        rem = dim
        for a in cand:
            if rem % sizes[a] == 0 and rem >= sizes[a]:
                picked.append(a)
                used.add(a)
                rem //= sizes[a]
        if not picked:
            parts.append(None)
        elif len(picked) == 1:
            parts.append(picked[0])
        else:
            parts.append(tuple(picked))
    # trim trailing Nones (canonical form)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _names(entry: Any) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: tuple, mesh: Any) -> list:
    """A PartitionSpec tuple as DTensor placements, one per mesh dim:
    ``Shard(d)`` on each mesh axis that tensor dim ``d`` names,
    ``Replicate()`` elsewhere.  A dim that names several mesh axes lists
    them major to minor, which DTensor reads in mesh-dim order, so they
    must come in that order.  A mesh axis of size 1 gets ``Replicate()``
    (the same layout), so that DTensor never meets a sharded dim it cannot
    view (a size-1 dim sharded over a size-1 axis)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _names(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} lists mesh axes against the mesh's order "
                             f"{tuple(names)}: DTensor shards major to minor in mesh order")
        for j in idx:
            if sizes[j] > 1:
                out[j] = Shard(d)
    return out


def tree_shardings(abstract: Any, axes_tree: Any, mesh: Any, rules: ShardingRules) -> Any:
    """A tree of placement lists matching an abstract (meta tensor) tree;
    ``axes_tree`` has ``abstract`` as a structural prefix, each leaf
    pairing with its whole axes tuple."""

    def one(leaf, axes):
        return placements(resolve_spec(tuple(axes), tuple(leaf.shape), mesh, rules), mesh)

    return tree_map(one, abstract, axes_tree)


# ---------------------------------------------------------------------------
# Logical axes of model inputs / states
# ---------------------------------------------------------------------------


def batch_axes(name: str, ndim: int) -> tuple[str | None, ...]:
    """Logical axes for a batch input by name/rank."""
    if name == "tokens":
        return ("batch", "seq")[:ndim] if ndim == 2 else ("batch",)
    if name == "labels":
        return ("batch", "seq")
    if name in ("enc_embeds", "patch_embeds"):
        return ("batch", "seq", "embed")
    if name == "positions":
        return ("batch", "seq", None)
    if name == "idx":
        return ()
    raise KeyError(name)


def cache_axes(leaf_shape: tuple[int, ...]) -> tuple[str | None, ...]:
    """KV-cache/state leaves: (layers, batch, time, kv, hd)-style."""
    n = len(leaf_shape)
    if n == 5:
        return ("layers", "batch", "seq", "kv", None)
    if n == 4:  # ssm state (L, B, nh|ds, ...) or conv (L, B, k, C)
        return ("layers", "batch", None, "state")
    if n == 3:
        return ("layers", "batch", "state")
    return tuple([None] * n)


def state_axes_tree(state: Any) -> Any:
    """Logical axes for a decode-state tree (shape-driven heuristics)."""
    return tree_map(lambda leaf: cache_axes(tuple(leaf.shape)), state)


def batch_axes_tree(batch: Any) -> Any:
    return {k: batch_axes(k, len(v.shape)) for k, v in batch.items()}
