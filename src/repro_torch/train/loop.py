"""Training loop: checkpoint auto-resume, async saves, health hooks.

Deterministic end to end: data is a pure function of the step counter
(see ``repro_torch.data``), so a restart from a checkpoint reproduces the
run's loss curve (bit for bit on the CPU; on CUDA the backward of the
embedding gather accumulates with atomics, in no fixed order).  The step
runs eagerly: the counterpart of the JAX package's ``TrainLoop(jit=True,
donate=True)``, a CUDA graph of the step as serving has for its steps
(``serve.graphs.CudaGraphStep``), is still to come.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from .._tree import tree_map
from ..ckpt.checkpoint import CheckpointManager
from ..ft.straggler import StragglerDetector

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


class TrainLoop:
    """Runs ``make_train_step`` over ``batch_fn(step)``'s numpy batches on
    the model's device."""

    def __init__(
        self,
        model,
        optimizer,
        batch_fn: Callable[[int], dict],
        config: TrainLoopConfig,
    ) -> None:
        self.model = model
        self.optimizer = optimizer
        self.batch_fn = batch_fn
        self.config = config
        self.step_fn = make_train_step(
            model,
            optimizer,
            microbatch=config.microbatch,
            compress_grads=config.compress_grads,
        )
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
