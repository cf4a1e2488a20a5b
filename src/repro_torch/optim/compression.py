"""Gradient compression for data-parallel reduction.

int8 block quantisation with error feedback: gradients are quantised per
256-value block before the (slow, cross-host) all-reduce and the
quantisation residual is added back into the next step's gradient.  Cuts
the collective's bytes 4x.  The JAX package's scheme, bit for bit:
zero-padded blocks, scale = max|x| / 127 floored at 1e-12, round half to
even, clip at +-127.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from .._tree import tree_map

__all__ = ["compress_int8", "decompress_int8", "ErrorFeedback"]

_BLOCK = 256


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantisation.  Returns (q, scales)."""
    flat = x.float().reshape(-1)
    pad = (-flat.shape[0]) % _BLOCK
    flat = F.pad(flat, (0, pad)).reshape(-1, _BLOCK)
    scale = torch.amax(torch.abs(flat), dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, shape: tuple[int, ...],
                    dtype: torch.dtype) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).to(dtype)


class ErrorFeedback:
    """Stateful error-feedback wrapper (state lives in the train state)."""

    @staticmethod
    def init(params: Any) -> Any:
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)

    @staticmethod
    def apply(grads: Any, residual: Any) -> tuple[Any, Any]:
        """Quantise (grad + residual); return (dequantised grads, new residual)."""

        def one(g, r):
            gf = g.float() + r
            q, s = compress_int8(gf)
            deq = decompress_int8(q, s, tuple(gf.shape), torch.float32)
            return deq.to(g.dtype), gf - deq

        pairs = tree_map(one, grads, residual)
        return (tree_map(lambda _g, t: t[0], grads, pairs),
                tree_map(lambda _g, t: t[1], grads, pairs))
