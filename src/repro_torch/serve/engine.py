"""Batched serving engine.

The engine prefills a batch of prompts together, then decodes with a
fixed-size state: KV caches are grown to ``max_len`` after the prefill so
every decode step has the same shapes (the SSM and hybrid states are
fixed-size already; the engine asks the model which leaves grow,
``Model.kv_caches``).  It runs on the device of the model's parameters
(``Model(device=...)``, CUDA unless the caller asks for the CPU); the
prefill goes through the flash-attention, SSD-scan or RG-LRU-scan kernel
there, decode through the decode-attention kernels.

``ServeEngine(model, config, jit=True)``, the default as in the JAX
package, runs each step as one program: on a CUDA model the prefill and
the decode step are each captured as a CUDA graph per input signature
(``repro_torch.graphs.CudaGraphStep``, the counterpart of ``jax.jit``), the kernels
launched inside the captured prefill, and decode replays one graph for
every position (``idx`` a 0-d int32 on the card, refilled each step) over
one ``max_len`` state updated in place (the counterpart of the
reference's ``donate_argnums=(1,)``).  On a CPU model nothing is
captured: ``jit=True`` runs the same eager steps as ``jit=False``.
``jit=False`` dispatches every op of every step from the host.

Greedy decoding takes ``argmax`` (the first maximum, as ``jnp.argmax``
does), so it gives the JAX package's tokens from the same weights.
``temperature > 0`` samples from a ``torch.Generator``; its bits differ
from ``jax.random.categorical``'s.  Sampling runs outside the graphs.

The engine's work is named by ``trace`` spans: ``serve.generate`` (the
whole call), ``serve.prefill`` (the batch to the device, the prefill and
its logits' copy), ``serve.decode`` (one a step: the position, the step
and its logits' copy), ``serve.sample`` and ``serve.stop`` (the EOS check
and its host read).  Each is a step of the trace, timed on the device with
tracing on, and a ``record_function`` range under a profiler.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F

from .. import trace
from .._tree import leaves, unflatten
from ..models.model import Model
from ..graphs import CudaGraphStep

__all__ = ["ServeConfig", "ServeEngine", "make_prefill_step", "make_decode_step"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 1024
    temperature: float = 0.0  # 0 = greedy
    eos_id: int = -1  # -1 = never stop early


def make_prefill_step(model: Model) -> Callable:
    """(batch) -> (last_logits, state)."""
    return model.prefill


def make_decode_step(model: Model) -> Callable:
    """(state, tokens, idx) -> (logits, state); updates the state in place.
    ``idx`` is an int or a 0-d int tensor on the model's device."""
    return model.decode_step


def _pad_cache_to(state: Any, model: Model, max_len: int, buffers: dict | None = None) -> Any:
    """Grow a prefill's KV caches (``model.kv_caches``) to ``max_len``
    positions (zeros after the prompt; a longer prompt's stay as they are);
    every other leaf passes through.

    With ``buffers`` (a dict), the result's leaves are the buffers kept
    there by their place in the tree, shape and dtype (made at their first
    use), written in place: each grown cache's prompt positions and the
    zeros after them, every other leaf whole.  Prefills of any prompt
    length then fill the same ``max_len`` buffers, as a captured prefill
    does."""
    grows = {id(t) for t in model.kv_caches(state)}
    if not grows and buffers is None:
        return state  # a fixed-size state passes through as it is

    def out(i: int, arr: torch.Tensor) -> torch.Tensor:
        n = arr.shape[2] if id(arr) in grows else None
        T = n if n is None else max(n, max_len)
        if buffers is None:
            return arr if T == n else F.pad(arr, (0, 0, 0, 0, 0, T - n))
        shape = arr.shape if n is None else (*arr.shape[:2], T, *arr.shape[3:])
        key = (i, tuple(shape), arr.dtype)
        dst = buffers.get(key)
        if dst is None:
            dst = buffers[key] = arr.new_empty(shape)
        if n is None:
            return dst.copy_(arr)
        dst.narrow(2, 0, n).copy_(arr)
        dst.narrow(2, n, T - n).zero_()
        return dst

    return unflatten(state, [out(i, t) for i, t in enumerate(leaves(state))])


class ServeEngine:
    """Prefill-then-decode engine over a fixed request batch.

    ``jit`` (default True): on a CUDA model, capture the prefill and the
    decode step as CUDA graphs, cached by input shapes and dtypes (one
    memory pool for both); a capture or replay that fails raises, with no
    eager retry.  On a CPU model, or with ``jit=False``, every step runs
    eagerly.

    What a capture keeps on the card: a prefill graph holds a copy of its
    batch and its (B, V) last logits, and writes its caches into the decode
    buffers (``_pad_cache_to``'s ``buffers``), so its own caches are scratch
    that every graph of the pool reuses; prompts of any length share the
    ``max_len`` buffers of their batch size (and, for an enc-dec model, of
    their encoder length), which a decode graph of that state updates in
    place.  A new batch size adds a decode graph and a ``max_len`` state
    that stay for the engine's life."""

    def __init__(self, model: Model, config: ServeConfig | None = None, *,
                 jit: bool = True) -> None:
        self.model = model
        self.config = config or ServeConfig()
        self.device = model.device
        self.jit = jit
        self._captured = jit and self.device.type == "cuda"
        max_len = self.config.max_len
        prefill, decode = make_prefill_step(model), make_decode_step(model)
        self._buffers: dict | None = {} if self._captured else None  # the decode states

        def prefill_step(batch):
            last, state = prefill(batch)
            return last, _pad_cache_to(state, model, max_len, self._buffers)

        self._prefill, self._decode = prefill_step, decode
        if self._captured:
            pool = torch.cuda.graph_pool_handle()
            self._prefill = CudaGraphStep(prefill_step, self.device, pool=pool,
                                          spans=model.traced)
            # the state and the position are the graph's own buffers (donated)
            self._decode = CudaGraphStep(decode, self.device, pool=pool, donate=(0, 2),
                                         spans=model.traced)
            self._idx = torch.zeros((), dtype=torch.int32, device=self.device)

    def _sample(self, logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        with trace.span("serve.sample", self.device, outer=True):
            if self.config.temperature <= 0:
                return torch.argmax(logits, dim=-1).to(torch.int32)
            probs = torch.softmax(logits.float() / self.config.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)

    def _on_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def prefill(self, batch: dict) -> tuple[torch.Tensor, Any]:
        """The prompts' last logits (B, V) and the decode state, KV caches
        grown to ``max_len`` positions (the prompt's, then zeros).  Under
        capture the state is the engine's buffer for these shapes: the next
        prefill of the same batch size overwrites it."""
        with trace.span("serve.prefill", self.device, outer=True):
            last, state = self._prefill(self._on_device(batch))
            return (last.clone() if self._captured else last), state

    def decode(self, state: Any, tokens: torch.Tensor,
               idx: int | torch.Tensor) -> tuple[torch.Tensor, Any]:
        """One step at position ``idx`` (an int or a 0-d int tensor on the
        engine's device); returns (logits (B, V), state), the state updated
        in place (under capture, the engine's buffer: a state passed in is
        copied there unless it is that buffer).  An int ``idx`` past the KV
        cache raises here; a tensor one is not checked (that would read the
        card), and past the cache a captured step's write is a device-side
        fault."""
        caches = self.model.kv_caches(state)
        if not isinstance(idx, torch.Tensor) and caches and not 0 <= idx < caches[0].shape[2]:
            raise IndexError(f"decode position {idx} is outside the KV cache's "
                             f"{caches[0].shape[2]} positions")
        with trace.span("serve.decode", self.device, outer=True):
            if not self._captured:
                return self._decode(state, tokens, idx)
            if isinstance(idx, torch.Tensor):
                self._idx.copy_(idx)
            else:
                self._idx.fill_(idx)  # a fill on the card, no sync
            logits, state = self._decode(state, tokens, self._idx)
            return logits.clone(), state

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
        seeded 0 if none is given.  With ``eos_id`` set, the stop check
        reads the card once a step (``bool(done.all())``), as the JAX
        package's does."""
        with trace.span("serve.generate", self.device, outer=True):
            return self._generate(batch, max_new_tokens, generator)

    def _generate(self, batch: dict, max_new_tokens: int,
                  generator: torch.Generator | None) -> torch.Tensor:
        batch = self._on_device(batch)
        gen = generator or torch.Generator(self.device).manual_seed(0)
        prompt_len = self.model.prompt_len(batch)
        room = max(self.config.max_len, prompt_len)
        if self.model.grows and prompt_len + max_new_tokens - 1 > room:
            # checked here: past the cache, a captured step's write is a device-side fault
            raise ValueError(f"{prompt_len} prompt positions and {max_new_tokens} new tokens "
                             f"need {prompt_len + max_new_tokens - 1} cache positions; the "
                             f"cache holds {room} (ServeConfig.max_len {self.config.max_len})")
        last_logits, state = self.prefill(batch)
        tokens = self._sample(last_logits, gen)
        out = [tokens]
        done = torch.zeros(tokens.shape, dtype=torch.bool, device=self.device)
        for t in range(1, max_new_tokens):
            logits, state = self.decode(state, tokens, prompt_len + t - 1)
            tokens = self._sample(logits, gen)
            if self.config.eos_id >= 0:
                with trace.span("serve.stop", self.device, outer=True):
                    done = done | (tokens == self.config.eos_id)
                    stop = bool(done.all())
                if stop:
                    out.append(tokens)
                    break
            out.append(tokens)
        return torch.stack(out, dim=1)
