"""Batched serving engine.

The engine prefills a batch of prompts together, then decodes with a
fixed-size state: KV caches are grown to ``max_len`` after the prefill so
every decode step has the same shapes (the SSM and hybrid states are
fixed-size already).  It runs on the device of the model's parameters
(``Model(device=...)``, CUDA unless the caller asks for the CPU); the
prefill goes through the flash-attention, SSD-scan or RG-LRU-scan kernel
there, decode through plain torch ops.

Greedy decoding takes ``argmax`` (the first maximum, as ``jnp.argmax``
does), so it gives the JAX package's tokens from the same weights.
``temperature > 0`` samples from a ``torch.Generator``; its bits differ
from ``jax.random.categorical``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..models.model import Model

__all__ = ["ServeConfig", "ServeEngine", "make_prefill_step", "make_decode_step"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 1024
    temperature: float = 0.0  # 0 = greedy
    eos_id: int = -1  # -1 = never stop early


def make_prefill_step(model: Model) -> Callable:
    """(batch) -> (last_logits, state)."""

    def prefill(batch):
        return model.prefill(batch)

    return prefill


def make_decode_step(model: Model) -> Callable:
    """(state, tokens, idx) -> (logits, state); updates the state in place."""

    def decode(state, tokens, idx):
        return model.decode_step(state, tokens, idx)

    return decode


def _pad_cache_to(state: Any, family: str, max_len: int) -> Any:
    """Grow a transformer's prefill caches ``(L, B, S, K, hd)`` to
    ``max_len`` positions (zeros after the prompt); an enc-dec model's
    self-attention caches likewise, its cross caches as they are.  The ssm
    and hybrid states (conv tails, recurrent states, the hybrid's ring
    caches of ``local_window`` slots) are fixed-size and pass through."""

    def pad_kv(arr):
        cur = arr.shape[2]
        if cur >= max_len:
            return arr
        return F.pad(arr, (0, 0, 0, 0, 0, max_len - cur))

    if family in ("dense", "moe", "vlm"):
        return (pad_kv(state[0]), pad_kv(state[1]))
    if family == "encdec":
        return {"self": (pad_kv(state["self"][0]), pad_kv(state["self"][1])),
                "cross": state["cross"]}
    return state  # ssm / hybrid states are fixed-size


class ServeEngine:
    """Prefill-then-decode engine over a fixed request batch."""

    def __init__(self, model: Model, config: ServeConfig | None = None) -> None:
        self.model = model
        self.config = config or ServeConfig()
        self.device = model.device
        self._prefill = make_prefill_step(model)
        self._decode = make_decode_step(model)

    def _sample(self, logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        if self.config.temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.config.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)

    def _on_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def generate(
        self,
        batch: dict,
        max_new_tokens: int,
        *,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Prefill ``batch`` (``tokens`` (B, S) ints, a tensor or an array;
        a vision model's ``patch_embeds`` prefix and ``positions``, an
        enc-dec model's ``enc_embeds``), then decode.  Returns the (B, new) int32 tokens on the engine's
        device.  ``generator`` (on that device) drives sampling; a fresh one
        seeded 0 if none is given."""
        batch = self._on_device(batch)
        gen = generator or torch.Generator(self.device).manual_seed(0)
        prompt_len = batch["tokens"].shape[1]
        if self.model.cfg.family == "vlm":
            prompt_len += batch["patch_embeds"].shape[1]
        last_logits, state = self._prefill(batch)
        state = _pad_cache_to(state, self.model.cfg.family, self.config.max_len)
        tokens = self._sample(last_logits, gen)
        out = [tokens]
        done = torch.zeros(tokens.shape, dtype=torch.bool, device=self.device)
        for t in range(1, max_new_tokens):
            logits, state = self._decode(state, tokens, prompt_len + t - 1)
            tokens = self._sample(logits, gen)
            if self.config.eos_id >= 0:
                done = done | (tokens == self.config.eos_id)
                if bool(done.all()):
                    out.append(tokens)
                    break
            out.append(tokens)
        return torch.stack(out, dim=1)
