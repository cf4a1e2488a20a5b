"""Parameter specification trees, as the JAX package describes them.

Every model describes its parameters as a nested dict of
:class:`ParamSpec` (shape, logical axes, initializer, dtype).  From one
spec tree this module derives the materialised tensors
(:func:`init_params`), the abstract tree of meta tensors
(:func:`abstract_params`: shapes and dtypes, no allocation), counts
(:func:`param_count`, :func:`param_bytes`) and the logical-axes tree
(:func:`logical_axes`, which ``repro_torch.sharding`` turns into DTensor
placements).

Logical axis names: ``layers`` (stacked-layer leading axis), ``embed``,
``heads``, ``kv``, ``mlp``, ``vocab``, ``expert``, ``state``, ``conv``,
``None``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

__all__ = [
    "ParamSpec",
    "init_params",
    "logical_axes",
    "abstract_params",
    "param_bytes",
    "param_count",
    "map_specs",
]

Initializer = str  # "normal" | "zeros" | "ones" | "embed" | "lecun" | "recurrent"


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: Initializer = "lecun"
    dtype: str = "float32"
    # fan-in override for stacked specs where the leading 'layers' axis
    # must not count toward the initializer's fan computation
    fan_in_dims: tuple[int, ...] | None = None

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def map_specs(fn: Callable[[tuple[str, ...], ParamSpec], Any], specs: Any) -> Any:
    """Map over a spec tree with path, preserving dict structure."""

    def rec(node: Any, path: tuple[str, ...]) -> Any:
        if isinstance(node, ParamSpec):
            return fn(path, node)
        if isinstance(node, dict):
            return {k: rec(v, path + (k,)) for k, v in node.items()}
        raise TypeError(f"unexpected node at {path}: {type(node)}")

    return rec(specs, ())


def _fan_in(spec: ParamSpec) -> int:
    dims = spec.fan_in_dims
    if dims is None:
        # default: all but the last dim (weights are [..., in, out] or [in, out])
        if len(spec.shape) <= 1:
            return max(1, math.prod(spec.shape))
        dims = tuple(range(len(spec.shape) - 1))
        # skip a leading stacked-layer axis
        if spec.axes and spec.axes[0] == "layers" and len(spec.shape) > 2:
            dims = tuple(d for d in dims if d != 0)
    return max(1, math.prod(spec.shape[d] for d in dims))


def _draw(spec: ParamSpec, shape: tuple[int, ...], gen: torch.Generator, device) -> torch.Tensor:
    kw = dict(dtype=torch.float32, device=device)
    if spec.init == "zeros":
        return torch.zeros(shape, **kw)
    if spec.init == "ones":
        return torch.ones(shape, **kw)
    if spec.init in ("embed", "normal"):
        # GPT-2-style 0.02 std: keeps tied-embedding logits O(1) at init
        return 0.02 * torch.randn(shape, generator=gen, **kw)
    if spec.init == "lecun":
        return torch.randn(shape, generator=gen, **kw) / math.sqrt(_fan_in(spec))
    if spec.init == "recurrent":
        # RG-LRU / SSM log-recurrence parameters: uniform in a stable range
        u = 0.9 + 0.099 * torch.rand(shape, generator=gen, **kw)
        return torch.log(u / (1.0 - u))  # logit of decay
    raise ValueError(f"unknown initializer {spec.init}")


def _init_one(spec: ParamSpec, gen: torch.Generator, device, dtype) -> torch.Tensor:
    dt = dtype or getattr(torch, spec.dtype)
    if spec.axes[0] != "layers" or len(spec.shape) == 1:
        return _draw(spec, spec.shape, gen, device).to(dt)
    # A stacked leaf is drawn a layer at a time, so the float32 draw never
    # holds more than one layer: moonshot-v1-16b-a3b's expert stack
    # (48, 64, 2048, 1408) would otherwise take a 35.4 GB float32 temporary
    # beside its bf16 weights.
    out = torch.empty(spec.shape, dtype=dt, device=device)
    for i in range(spec.shape[0]):  # the layers in order, from the one generator
        out[i] = _draw(spec, spec.shape[1:], gen, device)
    return out


def init_params(
    specs: Any,
    generator: torch.Generator,
    device: torch.device | str,
    dtype: torch.dtype | None = None,
) -> Any:
    """Materialise a parameter tree from a spec tree, drawing from
    ``generator`` (which must live on ``device``) leaf by leaf in the tree's
    order.  The initializer laws are the JAX package's; its draws come from
    jax's PRNG, so the numbers differ.  ``dtype`` overrides every leaf's
    stored type (the draws are made at float32 first; a stacked leaf a
    layer at a time)."""
    return map_specs(lambda _p, s: _init_one(s, generator, device, dtype), specs)


def logical_axes(specs: Any) -> Any:
    """The spec tree's logical axes, leaf for leaf."""
    return map_specs(lambda _p, s: s.axes, specs)


def abstract_params(specs: Any, device: torch.device | str = "meta") -> Any:
    """The spec tree as empty tensors of its shapes and stored dtypes on
    ``device`` ("meta": nothing is allocated)."""
    return map_specs(
        lambda _p, s: torch.empty(s.shape, dtype=getattr(torch, s.dtype), device=device), specs
    )


def param_count(specs: Any) -> int:
    total = 0

    def add(_p: tuple[str, ...], s: ParamSpec) -> None:
        nonlocal total
        total += math.prod(s.shape)

    map_specs(add, specs)
    return total


def param_bytes(specs: Any) -> int:
    total = 0

    def add(_p: tuple[str, ...], s: ParamSpec) -> None:
        nonlocal total
        total += math.prod(s.shape) * getattr(torch, s.dtype).itemsize

    map_specs(add, specs)
    return total
