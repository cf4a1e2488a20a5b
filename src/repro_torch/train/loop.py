"""Training loop: checkpoint auto-resume, async saves, health hooks.

Deterministic end to end: data is a pure function of the step counter
(see ``repro_torch.data``), and every sum of the step has a fixed order, on
the CPU and on the card (the embedding's and the MoE slots' backward go
through ``index_put_(accumulate=True)``, which sorts its indices on CUDA;
the loss's gather adds into each slot once), so a restart from a
checkpoint reproduces the run's loss curve bit for bit.

``TrainLoop(..., jit=True, donate=True)`` takes the JAX package's
keywords and defaults.  On a CUDA model ``jit=True`` captures the whole
step (forward, checkpoint recompute, backward, error feedback, clip,
update, step counter) as one CUDA graph for each batch signature
(``graphs.CudaGraphStep``, the port's ``jax.jit``): the first step
of a signature runs eagerly as the warm-up, then captures, so its
``step_time`` holds both, as the reference's first step holds its
compilation; later steps replay the graph with no host dispatch.
``donate=True`` makes the train state's leaves the graph's static inputs
and writes the new state into them in place, inside the graph: the step
returns the same leaves, updated, and one state stays alive across steps.
``donate=False`` captures over clones of the state and never writes the
caller's: the state it returns is the graph's output, which holds until
the next replay.  On a CPU model, and with ``jit=False`` anywhere, every
step runs eagerly and returns a new state (``donate`` changes nothing),
as ``ServeEngine(jit=True)`` does.  There is no fallback: a warm-up,
capture or replay that fails raises (a host read in the step, such as
``.item()``, makes the capture fail), and nothing is retried eagerly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from .._tree import leaves, tree_map
from ..ckpt.checkpoint import CheckpointManager
from ..ft.straggler import StragglerDetector
from ..graphs import CudaGraphStep

from .step import TrainState, init_train_state, make_train_step

__all__ = ["TrainLoopConfig", "TrainLoop"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    log_every: int = 10
    ckpt_dir: str = ""
    keep: int = 3
    microbatch: int = 0
    compress_grads: bool = False
    predicted_step_time: float = 0.0  # straggler baseline (0 = off)


def _in_place(step_fn: Callable) -> Callable:
    """``step_fn`` writing the new state into the given state's leaves, in
    place (the donated step's write-back): it returns the given state."""

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        new, metrics = step_fn(state, batch)
        torch._foreach_copy_(leaves(state), leaves(new))
        return state, metrics

    return step


class TrainLoop:
    """Runs ``make_train_step`` over ``batch_fn(step)``'s numpy batches on
    the model's device; on a CUDA model and under ``jit`` (the default)
    as a CUDA graph of the step, over the donated state under ``donate``
    (see the module's docstring)."""

    def __init__(
        self,
        model,
        optimizer,
        batch_fn: Callable[[int], dict],
        config: TrainLoopConfig,
        *,
        jit: bool = True,
        donate: bool = True,
    ) -> None:
        self.model = model
        self.optimizer = optimizer
        self.batch_fn = batch_fn
        self.config = config
        step = make_train_step(
            model,
            optimizer,
            microbatch=config.microbatch,
            compress_grads=config.compress_grads,
        )
        if jit and model.device.type == "cuda":
            if donate:
                step = CudaGraphStep(_in_place(step), model.device, donate=(0,))
            else:
                step = CudaGraphStep(step, model.device)
        self.step_fn = step
        self.ckpt = (
            CheckpointManager(config.ckpt_dir, keep=config.keep)
            if config.ckpt_dir
            else None
        )
        self.straggler = StragglerDetector()
        self.history: list[dict] = []

    def init_or_resume(self, generator: torch.Generator) -> TrainState:
        state = init_train_state(
            self.model, self.optimizer, generator, compress=self.config.compress_grads
        )
        if self.ckpt is not None:
            restored = self.ckpt.restore(state)
            if restored is not None:
                tree, _meta = restored
                state = tree_map(lambda like, x: x.to(like.device), state, tree)
        return state

    def run(self, generator: torch.Generator, *, on_step=None) -> TrainState:
        """Train from a fresh state drawn from ``generator`` (on the
        model's device), or from the newest checkpoint, to
        ``total_steps``."""
        cfg = self.config
        state = self.init_or_resume(generator)
        start = int(state.step)
        for step in range(start, cfg.total_steps):
            batch = {k: torch.as_tensor(np.ascontiguousarray(v), device=self.model.device)
                     for k, v in self.batch_fn(step).items()}
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
            dt = time.perf_counter() - t0
            metrics.update(step=step, step_time=dt)
            self.history.append(metrics)
            if cfg.predicted_step_time > 0:
                self.straggler.observe(0, dt, cfg.predicted_step_time)
            if on_step is not None:
                on_step(step, metrics)
            if cfg.log_every and step % cfg.log_every == 0:
                print(
                    f"step {step:6d}  loss {metrics['loss']:.4f}  "
                    f"gnorm {metrics['grad_norm']:.3f}  {dt*1e3:.1f} ms"
                )
            if self.ckpt is not None and cfg.ckpt_every and (step + 1) % cfg.ckpt_every == 0:
                self.ckpt.save(int(state.step), state)
        if self.ckpt is not None:
            self.ckpt.save(int(state.step), state, sync=True)
        return state
