"""Nested containers of tensors in the JAX package's pytree order.

The port keeps parameters, optimizer states and train states as nested
dicts, tuples, lists and dataclasses, as the JAX package does, and walks
them in ``jax.tree``'s leaf order: dict keys sorted, tuples and lists in
order, dataclass fields in declaration order, ``None`` an empty subtree.
Checkpoints are written leaf by leaf in that order, so one written by
either package restores in the other, and the optimizers sum and update
leaves in the order the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

__all__ = ["leaves", "unflatten", "tree_map"]


def _children(node: Any) -> list | None:
    """The node's subtrees in leaf order, or None for a leaf."""
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [getattr(node, f.name) for f in dataclasses.fields(node)]
    return None


def _rebuild(node: Any, children: list) -> Any:
    if isinstance(node, dict):
        by_key = dict(zip(sorted(node), children, strict=True))
        return {k: by_key[k] for k in node}
    if isinstance(node, (tuple, list)):
        return type(node)(children)
    return dataclasses.replace(node, **{f.name: c for f, c in
                                        zip(dataclasses.fields(node), children, strict=True)})


def _iter(node: Any) -> Iterator[Any]:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        yield node
        return
    for kid in kids:
        yield from _iter(kid)


def leaves(tree: Any) -> list:
    """The tree's leaves in ``jax.tree.leaves`` order."""
    return list(_iter(tree))


def unflatten(like: Any, flat: list) -> Any:
    """``like``'s structure with its leaves replaced, in order, by ``flat``."""
    it = iter(flat)

    def rec(node: Any) -> Any:
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [rec(k) for k in kids])

    out = rec(like)
    if next(it, None) is not None:
        raise ValueError(f"{len(flat)} leaves given for a tree of {len(leaves(like))}")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over ``tree``'s leaves; each of ``rest`` has ``tree``'s
    structure down to those leaves and hands ``fn`` the subtree found there
    (``jax.tree.map``'s prefix rule)."""

    def rec(node: Any, others: tuple) -> Any:
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return fn(node, *others)
        split = [_children(o) for o in others]
        for o, s in zip(others, split, strict=True):
            if (s is None or len(s) != len(kids) or type(o) is not type(node)
                    or (isinstance(node, dict) and sorted(o) != sorted(node))):
                raise ValueError(f"tree structures differ: {type(node).__name__} against "
                                 f"{type(o).__name__}")
        return _rebuild(node, [rec(k, tuple(s[i] for s in split)) for i, k in enumerate(kids)])

    return rec(tree, rest)
