"""Optimizers as pure transforms of parameter trees.

``init(params) -> state`` and ``update(grads, state, params, step) ->
(new_params, new_state)`` over nested dicts of tensors, returning new
tensors and mutating none: the JAX package's optimizers, in its float32
arithmetic and order of operations (moments are always float32, the
update is computed at float32 and cast back to the parameter's type).
Optimizer state mirrors the parameter tree.  ``torch.optim`` is not used:
its AdamW clips nothing and its update differs in order, and it has no
Adafactor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .._tree import leaves, tree_map
from .schedules import constant_lr

__all__ = [
    "Optimizer",
    "OptState",
    "AdamW",
    "SGD",
    "Adafactor",
    "global_norm",
    "clip_by_global_norm",
]

OptState = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, at float32, leaves summed
    in the tree's order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


def clip_by_global_norm(tree: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def _split(like: Any, tree: Any, i: int) -> Any:
    """Element ``i`` of each tuple that ``tree`` holds at ``like``'s leaves."""
    return tree_map(lambda _l, t: t[i], like, tree)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """init(params) -> state;  update(grads, state, params, step) ->
    (new_params, new_state)."""

    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any, torch.Tensor], tuple[Any, OptState]]


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def AdamW(
    lr: float | Schedule = 1e-3,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
) -> Optimizer:
    sched = lr if callable(lr) else constant_lr(lr)

    def init(params):
        return {"m": tree_map(_zeros, params), "v": tree_map(_zeros, params)}

    def update(grads, state, params, step):
        if grad_clip > 0:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        lr_t = sched(step)
        t = step.float() + 1.0
        c1 = 1.0 - b1**t
        c2 = 1.0 - b2**t

        def upd(g, m, v, p):
            gf = g.float()
            m_new = b1 * m + (1 - b1) * gf
            v_new = b2 * v + (1 - b2) * gf * gf
            mhat = m_new / c1
            vhat = v_new / c2
            step_ = mhat / (torch.sqrt(vhat) + eps)
            pf = p.float()
            pf = pf - lr_t * (step_ + weight_decay * pf)
            return pf.to(p.dtype), m_new, v_new

        flat = tree_map(upd, grads, state["m"], state["v"], params)
        return _split(grads, flat, 0), {"m": _split(grads, flat, 1), "v": _split(grads, flat, 2)}

    return Optimizer(init=init, update=update)


def SGD(lr: float | Schedule = 1e-2, *, momentum: float = 0.9, grad_clip: float = 0.0) -> Optimizer:
    sched = lr if callable(lr) else constant_lr(lr)

    def init(params):
        return {"mom": tree_map(_zeros, params)}

    def update(grads, state, params, step):
        if grad_clip > 0:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        lr_t = sched(step)

        def upd(g, mo, p):
            mo_new = momentum * mo + g.float()
            return (p.float() - lr_t * mo_new).to(p.dtype), mo_new

        flat = tree_map(upd, grads, state["mom"], params)
        return _split(grads, flat, 0), {"mom": _split(grads, flat, 1)}

    return Optimizer(init=init, update=update)


def Adafactor(
    lr: float | Schedule = 1e-3,
    *,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Memory-frugal Adafactor-lite: factored second moment for matrices
    (row/col running averages over the last two axes), full for vectors,
    and the update clipped to an RMS of ``clip_threshold``."""
    sched = lr if callable(lr) else constant_lr(lr)

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def one(p):
            if _factored(p.shape):
                return {
                    "row": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "col": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                       device=p.device),
                }
            return {"v": _zeros(p)}

        return {"f": tree_map(one, params)}

    def update(grads, state, params, step):
        lr_t = sched(step)
        t = step.float() + 1.0
        beta = 1.0 - t**-0.8

        def upd(g, f, p):
            gf = g.float()
            g2 = gf * gf + eps
            if _factored(p.shape):
                row = beta * f["row"] + (1 - beta) * g2.mean(dim=-1)
                col = beta * f["col"] + (1 - beta) * g2.mean(dim=-2)
                rms_approx = (
                    row[..., None]
                    * col[..., None, :]
                    / torch.clamp_min(row.mean(dim=-1, keepdim=True)[..., None], eps)
                )
                upd_ = gf / torch.sqrt(rms_approx + eps)
                new_f = {"row": row, "col": col}
            else:
                v = beta * f["v"] + (1 - beta) * g2
                upd_ = gf / torch.sqrt(v + eps)
                new_f = {"v": v}
            # update clipping (Adafactor's RMS clip)
            rms_u = torch.sqrt(torch.mean(upd_ * upd_))
            upd_ = upd_ / torch.clamp_min(rms_u / clip_threshold, 1.0)
            pf = p.float()
            pf = pf - lr_t * (upd_ + weight_decay * pf)
            return pf.to(p.dtype), new_f

        flat = tree_map(upd, grads, state["f"], params)
        return _split(grads, flat, 0), {"f": _split(grads, flat, 1)}

    return Optimizer(init=init, update=update)
