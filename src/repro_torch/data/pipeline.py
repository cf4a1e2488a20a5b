"""Deterministic synthetic token pipeline, host numpy, the JAX package's
stream bit for bit.

Batches are a pure function of (seed, step): restart-safe (a resumed run
regenerates the identical stream, so checkpoint/restart is exactly
reproducible) and host-shardable (each host materialises only its slice
of the global batch, keyed by the same counters).

The token stream is a learnable-structure Markov-ish sequence (token t+1
= hash(t) with noise) rather than i.i.d. noise, so small-model training
loss demonstrably falls.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ..configs.base import ModelConfig
from ..configs.shapes import InputShape

__all__ = ["SyntheticLM", "make_batch_fn"]


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Synthetic autoregressive stream over a vocab."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: float = 0.9  # prob. that t+1 follows the hash rule

    def _rows(self, step: int, row0: int, rows: int) -> np.ndarray:
        """Deterministic (rows, seq_len) int32 block."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, row0, rows])
        )
        first = rng.integers(0, self.vocab, size=(rows, 1))
        out = np.empty((rows, self.seq_len), dtype=np.int64)
        out[:, :1] = first
        # hash rule: next = (a * tok + b) % vocab, with structure noise
        a, b = 6364136223846793005 % self.vocab or 1, 1442695040888963407 % self.vocab
        noise = rng.random((rows, self.seq_len))
        rand_toks = rng.integers(0, self.vocab, size=(rows, self.seq_len))
        for t in range(1, self.seq_len):
            nxt = (out[:, t - 1] * a + b) % self.vocab
            out[:, t] = np.where(noise[:, t] < self.structure, nxt, rand_toks[:, t])
        return out.astype(np.int32)

    def batch(self, step: int, *, host_id: int = 0, host_count: int = 1) -> dict:
        """Host-sharded batch: host i materialises rows [i*per, (i+1)*per)."""
        per = self.global_batch // host_count
        rows = self._rows(step, host_id * per, per)
        return {"tokens": rows, "labels": rows}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_batch_fn(cfg: ModelConfig, shape: InputShape, seed: int = 0):
    """Batch generator including modality-stub inputs (audio/vision), as
    numpy arrays: ``tokens`` and ``labels``; an enc-dec model's
    ``enc_embeds``; a vision model's ``patch_embeds`` prefix and its 3-D
    ``positions``."""
    stream = SyntheticLM(cfg.vocab, shape.seq_len, shape.global_batch, seed)

    def fn(step: int) -> dict:
        batch = stream.batch(step)
        B, S = shape.global_batch, shape.seq_len
        rng = np.random.default_rng(np.random.SeedSequence([seed + 7, step]))
        if cfg.family == "encdec":
            batch["enc_embeds"] = rng.standard_normal(
                (B, S, cfg.d_model), dtype=np.float32
            ).astype(np.dtype(cfg.dtype) if cfg.dtype != "bfloat16" else np.float32)
        if cfg.family == "vlm":
            from ..models.model import VLM_PATCHES

            P = min(VLM_PATCHES, S // 2)
            batch["tokens"] = batch["tokens"][:, : S - P]
            batch["patch_embeds"] = rng.standard_normal(
                (B, P, cfg.d_model), dtype=np.float32
            )
            pos = np.broadcast_to(np.arange(S)[None, :, None], (B, S, 1))
            batch["positions"] = np.broadcast_to(pos, (B, S, 3)).astype(np.int32)
        return batch

    return fn
