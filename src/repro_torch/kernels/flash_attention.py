"""Flash attention: the CUDA kernel (``csrc/flash_attention.cu``) beside its
plain torch version.

Counterpart of the JAX package's TPU kernel ``flash_attention_pallas``:
online-softmax GQA attention with causal masking, a ``q_offset`` for the
queries' absolute positions, a sliding ``window`` and a kv-edge mask, with
float32 m / l / acc and causal tiles skipped.  q is (B, S, H, hd), k and v
are (B, T, K, hd), H a multiple of K; query head h reads kv head
h // (H / K).  The output has q's shape and type.

``flash_attention_plain`` is a masked softmax at float32 (``ref.attention_ref``):
the CPU path and the kernel's yardstick on the card.  ``ops.flash_attention``
picks between the two by the tensors' device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import attention_ref

__all__ = ["flash_attention_cuda", "flash_attention_plain", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128, 256)  # the head widths the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[int, ...]:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,H,hd), k = v (B,T,K,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or K == 0 or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         f"(batch, head dim, or H not a multiple of K)")
    return B, S, H, K, T, hd


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """The same attention as a masked softmax at float32, on the inputs'
    device.  A row with no visible key averages every value (a softmax over
    -1e30), where the kernel averages the values of the tiles it visited;
    a causal prefill has no such row."""
    _check(q, k, v)
    return attention_ref(q, k, v, q_offset=q_offset, causal=causal, window=window)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; does not synchronise.

    q, k and v are contiguous CUDA tensors of one type, float32 or
    bfloat16, with a head dim in ``HEAD_DIMS``.
    ``flash_attention_cuda.launches`` counts the launches made (an empty
    ``B * H * S`` returns an empty output and launches nothing; ``T == 0``
    raises).
    """
    B, S, H, K, T, hd = _check(q, k, v)
    _build.check_cuda(0, q=q, k=k, v=v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one the kernel is built for {HEAD_DIMS}")
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"B * H = {B * H} exceeds the grid's y extent {_MAX_GRID_Y}")
    if T == 0:
        raise ValueError("attention over an empty key sequence")
    out = torch.empty_like(q)
    if B * H * S == 0:
        return out  # a grid of zero blocks is a launch error
    _build.launch("flash_attention", "flash_attention_fwd", _ARGTYPES, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        B, S, T, H, K, hd, int(q_offset), int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
    ), q.device)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
