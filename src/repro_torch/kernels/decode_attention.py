"""Decode attention: one query position against a key / value cache, as a
split-K CUDA kernel (``csrc/decode_attention.cu``) over the cache in its
own type.

The JAX package has no kernel here: its decode runs the online softmax of
``chunked_attention`` in XLA ops, and so does this package's plain route
(``layers.chunked_attention``, the CPU path and the kernel's yardstick on
the card).  That route widens the whole ``(B, T, K, hd)`` cache to float32
and repeats it over the query heads each step; the kernel reads each
cached row once, in bfloat16 or float32, for all the query heads of its kv
head, and does float32 arithmetic inside.

What it computes, for the S = 1 query of row b and head h (kv head
h // (H / K)) at position ``q_offset``: softmax(scale * q k^T) v over the
visible keys, scale = 1 / sqrt(hd), q widened as ``float(q) * scale``;
key t is visible when t < min(T, kv_len), t <= q_offset (causal) and
q_offset - t < window (window > 0).  Scores, softmax and the products
are float32; under ``p_dtype="bfloat16"`` p and v are rounded to bfloat16
before p @ v, as ``chunked_attention`` does.  A row with no visible key
averages every value of the cache, as ``chunked_attention``'s one chunk
of T keys does (its scores are all -1e30 there).  The output is in q's
type.

``kv_len`` and ``q_offset`` are ints or 0-d integer tensors on the card,
read inside the kernel, so a captured decode step replays at every
position without a read on the host, and its work follows the live
length: the key splits that lie wholly past it exit at once.  The grid
and the split count come from the shapes alone (``decode_plan``); the
splits' partial (m, l, acc) are merged in a fixed order, so a call is
bitwise the same from run to run.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from . import _build
from .flash_attention import HEAD_DIMS

__all__ = ["decode_attention_cuda", "decode_plan", "DecodePlan"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P_DTYPES = {"float32": 0, "bfloat16": 1}

# The kernel's shape, as ``csrc/decode_attention.cu`` sets it.
_WARPS = 4
_STEPS = 4  # row steps of a staged tile
_STAGES_MAX = 4  # tiles a block has in flight or in use at most
_STAGE_BUDGET = 65536  # shared-memory bytes of a block's stages
_MAX_HEADS = 8  # query heads a block at most
_WAVES = 8  # blocks an SM the split count aims at
_MAX_GRID = 2**31 - 1
H100_SMS = 132

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
             _P, _L, _I, _P, _L, _I, _I, _I, _F, _I, _I, _I]


@dataclass(frozen=True)
class DecodePlan:
    """The launch of ``decode_attention.cu`` for one call: ``grid`` blocks,
    one a (row b, kv head, chunk of ``heads`` query heads, key split), as
    the kernel decodes ``blockIdx.x``.  Split s reads the cache rows
    [s * split_keys, (s + 1) * split_keys) below T, in staged tiles of
    ``tile`` rows; with more than one split a second kernel merges the
    splits' partials in split order.  ``tile`` and ``smem`` are checked
    by the kernel's launcher against its build."""

    B: int
    H: int
    K: int
    T: int
    hd: int
    heads: int  # query heads a block: the kernel's template width
    chunks: int  # blocks of query heads a kv head
    tile: int  # keys a staged tile
    smem: int  # dynamic shared-memory bytes a block
    split_keys: int  # keys a split, a multiple of ``tile``
    splits: int
    grid: int  # blocks of the split kernel


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def decode_plan(B: int, H: int, K: int, T: int, hd: int, dtype: torch.dtype,
                p_dtype: str = "float32", *, sm_count: int = H100_SMS) -> DecodePlan:
    """The kernel's launch for q (B, 1, H, hd) against a (B, T, K, hd)
    cache of ``dtype``.  The split count is what it takes for the grid to
    give each of ``sm_count`` SMs about ``_WAVES`` blocks, with a split at
    least one tile long; raises on what the kernel is not built for."""
    if dtype not in _DTYPES:
        raise TypeError(f"decode attention runs float32 or bfloat16, got {dtype}")
    if p_dtype not in _P_DTYPES:
        raise ValueError(f"p_dtype {p_dtype!r}: want one of {sorted(_P_DTYPES)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one the kernel is built for {HEAD_DIMS}")
    if min(B, H, K, T) < 1 or H % K:
        raise ValueError(f"want B, T >= 1 and H a multiple of K; got B {B}, H {H}, K {K}, T {T}")
    group = H // K
    per = _cdiv(group, _cdiv(group, _MAX_HEADS))  # query heads a block, as even as it goes
    chunks = _cdiv(group, per)
    es = torch.finfo(dtype).bits // 8
    lanes = min(32, hd * es // 16)  # lanes that share a key row, 16 bytes each
    tile = _WARPS * (32 // lanes) * _STEPS
    stage = 2 * tile * hd * es  # a K and a V tile
    stages = min(_STAGES_MAX, _STAGE_BUDGET // stage)
    smem = max(stages * stage, _WARPS * per * (hd + 2) * 4)  # or the warps' (acc, m, l)
    pairs = B * K * chunks
    split_keys = tile * _cdiv(T, _cdiv(_WAVES * sm_count, pairs) * tile)
    splits = _cdiv(T, split_keys)
    grid = pairs * splits
    if grid > _MAX_GRID:
        raise ValueError(f"{grid} blocks exceed the grid")
    return DecodePlan(B=B, H=H, K=K, T=T, hd=hd, heads=per, chunks=chunks, tile=tile,
                      smem=smem, split_keys=split_keys, splits=splits, grid=grid)


def _position(x: int | torch.Tensor | None, default: int, device: torch.device, name: str):
    """(pointer, value, is_int64) of a position: an int as a value, a 0-d
    integer tensor on ``device`` as a pointer the kernel reads, one on the
    host as its value."""
    if x is None:
        return None, default, 0
    if not isinstance(x, torch.Tensor):
        return None, int(x), 0
    if x.numel() != 1 or x.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name} must be an int or a one-element int32 / int64 tensor, got "
                        f"{x.dtype} of shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return None, int(x), 0
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the attention on {device}")
    return x.data_ptr(), 0, int(x.dtype == torch.int64)


def decode_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_offset: int | torch.Tensor = 0,
    kv_len: int | torch.Tensor | None = None,
    causal: bool = True,
    window: int = 0,
    p_dtype: str = "float32",
    scale: float | None = None,
) -> torch.Tensor:
    """Attention of q (B, 1, H, hd) against k, v (B, T, K, hd), launched on
    the current stream; does not synchronise.  Scores are scaled by
    ``scale``, 1 / sqrt(hd) if None.

    q, k and v are contiguous, 16-byte aligned CUDA tensors of one type,
    float32 or bfloat16, with a head dim in ``HEAD_DIMS``; ``kv_len`` None
    means all T rows are filled.  ``decode_attention_cuda.launches``
    counts the calls (a call with more than one split also runs the merge
    kernel, counted as its part).  The kernel has no backward: under grad
    mode, inputs that require grad raise.
    """
    _build.check_no_grad("decode_attention_cuda", q=q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or q.shape[1] != 1:
        raise ValueError(f"want q (B,1,H,hd), k = v (B,T,K,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree in batch or head dim")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a type, got {q.dtype}, {k.dtype}, {v.dtype}")
    plan = decode_plan(B, H, K, T, hd, q.dtype, p_dtype,
                       sm_count=torch.cuda.get_device_properties(q.device).multi_processor_count)
    _build.check_cuda(plan.smem, q=q, k=k, v=v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the kernel reads q, k, v in 16-byte units: they must be 16-byte aligned")
    off_ptr, off, off64 = _position(q_offset, 0, q.device, "q_offset")
    len_ptr, length, len64 = _position(kv_len, T, q.device, "kv_len")
    out = torch.empty_like(q)
    part = (torch.empty(B * H * plan.splits * (hd + 2), dtype=torch.float32, device=q.device)
            if plan.splits > 1 else None)  # the splits' (acc, m, l)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            _DTYPES[q.dtype], B, T, H, K, hd, plan.heads, plan.chunks, plan.split_keys,
            plan.splits, off_ptr, off, off64, len_ptr, length, len64, int(bool(causal)),
            int(window), 1.0 / math.sqrt(hd) if scale is None else float(scale),
            _P_DTYPES[p_dtype], plan.tile, plan.smem)
    _build.launch("decode_attention", "decode_attention_fwd", _ARGTYPES, args, q.device)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
