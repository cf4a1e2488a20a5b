"""Train-step factory: loss -> grads -> (optionally compressed) update.

The produced step is a function ``(state, batch) -> (state, metrics)``
that returns a new state and mutates none, as the JAX package's is pure:
the gradient is ``torch.autograd.grad`` of ``Model.loss`` over the float32
leaves of ``state.params`` (the master weights; the model computes in
``cfg.dtype``).  The model's ``ExecConfig`` must take the differentiable
route, ``attn_impl="xla"``: the hand-written kernels have no backward and
raise on inputs that require grad.

Called directly, the step runs eagerly.  ``TrainLoop(jit=True)`` (the
default) captures it on a CUDA model as one CUDA graph a batch signature,
and under ``donate=True`` wraps it to write the new state into the given
one in place; on a CPU model, or with ``jit=False``, the loop runs it as
it is.  Nothing in the step reads the card from the host (the schedule
and the bias corrections read ``state.step`` on the device, the clip and
the norm stay tensors), which is what lets it be captured.

Features:
* microbatch gradient accumulation (a loop over the split batch),
* optional int8 + error-feedback gradient compression,
* metrics: loss, CE, MoE aux, grad global-norm.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .._tree import leaves, tree_map, unflatten
from ..models.model import Model
from ..optim.compression import ErrorFeedback
from ..optim.optimizers import Optimizer, global_norm

__all__ = ["TrainState", "make_train_step", "train_state_axes"]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor  # 0-d int32
    ef_residual: Any = None  # error-feedback state (compression on)


def train_state_axes(model: Model, *, compress: bool = False) -> TrainState:
    """Logical-axes tree matching TrainState (for sharding resolution)."""
    p_axes = model.param_axes()
    # AdamW/SGD moments mirror params exactly
    opt_axes = {"m": p_axes, "v": p_axes}
    return TrainState(
        params=p_axes,
        opt_state=opt_axes,
        step=(),
        ef_residual=p_axes if compress else None,
    )


def make_train_step(
    model: Model,
    optimizer: Optimizer,
    *,
    microbatch: int = 0,
    compress_grads: bool = False,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:

    def grads_of(params, batch):
        flat = leaves(params)
        live = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            loss, metrics = model.loss(unflatten(params, live), batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads, strict=True)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                unflatten(params, grads))

    def accumulate(params, batch):
        """Microbatched grads: mean over `microbatch` slices of the batch."""
        nb = microbatch
        dev = leaves(params)[0].device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev), params)
        for i in range(nb):
            mb = {k: x.reshape(nb, x.shape[0] // nb, *x.shape[1:])[i] for k, x in batch.items()}
            loss_i, _m, grads_i = grads_of(params, mb)
            loss = loss + loss_i / nb
            grads = tree_map(lambda a, g: a + g / nb, grads, grads_i)
        return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32, device=dev)}, grads

    def step_fn(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if microbatch and microbatch > 1:
            loss, metrics, grads = accumulate(state.params, batch)
        else:
            loss, metrics, grads = grads_of(state.params, batch)

        with torch.no_grad():
            ef = state.ef_residual
            if compress_grads:
                grads, ef = ErrorFeedback.apply(grads, ef)

            gnorm = global_norm(grads)
            new_params, new_opt = optimizer.update(grads, state.opt_state, state.params,
                                                   state.step)
        new_state = TrainState(
            params=new_params,
            opt_state=new_opt,
            step=state.step + 1,
            ef_residual=ef,
        )
        out = {"loss": loss, "grad_norm": gnorm, **metrics}
        return new_state, out

    return step_fn


def init_train_state(
    model: Model, optimizer: Optimizer, generator: torch.Generator, *, compress: bool = False
) -> TrainState:
    params = model.init(generator)
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        step=torch.zeros((), dtype=torch.int32, device=model.device),
        ef_residual=ErrorFeedback.init(params) if compress else None,
    )
