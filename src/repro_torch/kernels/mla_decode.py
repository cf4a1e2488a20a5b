"""Latent decode attention: latent attention's (MLA's) absorbed decode step
as a split-K CUDA kernel (``csrc/mla_decode.cu``, kernel 7: bfloat16 on
the tensor cores, float32 on the CUDA cores) beside its plain torch
version.

One query position a row: q (B, H, r + rope), each head's latent query
(q_nope W_k_b^T) then its rotated rope query, against the cache's latent
c (B, T, r) and rope key (B, T, rope), which every head shares; the
latent c is also the value.  For row b and head h,

    out[b, h] = softmax_t(scale * (q_lat . c_t + q_rope . r_t)) c

over the visible tokens t < n, n = min(T, max(kv_len, 1)); the output is
(B, H, r) in q's type, which the caller maps through W_v_b and W_o.  q
is widened as ``float(q) * scale``; scores, softmax and the sum are
float32.

``kv_len`` is an int or a 0-d integer tensor on the card, read inside the
kernel, so a captured decode step replays at every fill.  The split count
comes from the shapes alone (``mla_plan``: as many blocks as the card
holds at once, two an SM, over the rows); each split takes ceil(n / splits)
keys rounded up to whole tiles, read on the device, and the live splits'
partials are merged in split order, so a call is bitwise the same from run
to run.  The kernel is built for r = 512, rope = 64 and H = 16 (Moonlight's
widths; the heads are one 16-row tensor-core tile); the wrapper raises on
anything else, and CPU tensors take ``mla_decode_plain``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .decode_attention import H100_SMS, _cdiv, _position

__all__ = ["mla_decode_cuda", "mla_decode_plain", "mla_plan", "MlaPlan", "LATENT", "ROPE",
           "HEADS"]

LATENT, ROPE, HEADS = 512, 64, 16  # the widths and query heads the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The kernel's shape, as ``csrc/mla_decode.cu`` sets it: (keys a staged
# tile, dynamic shared-memory bytes a block) by type.  bfloat16: q's 16 rows
# and two tiles of 32 rows, each padded by 16 bytes, the tile's float32
# scores and three floats a row; float32: two tiles of 16 unpadded rows.
_SHAPE = {torch.bfloat16: (32, (16 + 2 * 32) * (576 + 8) * 2 + 16 * 32 * 4 + 3 * 16 * 4),
          torch.float32: (16, 2 * 16 * 576 * 4)}
# blocks an SM the split count aims at: what fits at once (shared memory
# holds two bf16 blocks an SM); at the cell's shape (64 rows, fill 512) 4
# splits read 35.4 us a launch, 5 36.5, 8 53.0, 16 86.6 (H100, PERF.md §6)
_WAVES = 2
_MAX_GRID = 2**31 - 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _L, _I, _F, _I, _I]


@dataclass(frozen=True)
class MlaPlan:
    """The launch of ``mla_decode.cu`` for one call: ``grid`` blocks, one a
    (row b, key split), as the kernel decodes ``blockIdx.x``, each of
    ``threads`` (four warps; in float32 a warp a four query heads).  With more than one split a second kernel merges the live
    splits' partials.  ``tile`` and ``smem`` are checked by the kernel's
    launcher against its build."""

    B: int
    H: int
    T: int
    threads: int
    tile: int
    smem: int  # dynamic shared-memory bytes a block: its staged tiles
    splits: int
    grid: int


def mla_plan(B: int, H: int, T: int, dtype: torch.dtype, *,
             sm_count: int = H100_SMS) -> MlaPlan:
    """The kernel's launch for q (B, H, 576) against a (B, T) cache of
    ``dtype``: as many key splits as give each of ``sm_count`` SMs at most
    ``_WAVES`` blocks (at least one split, at most one a tile of the cache);
    raises on what the kernel is not built for."""
    if dtype not in _DTYPES:
        raise TypeError(f"latent decode attention runs float32 or bfloat16, got {dtype}")
    if H != HEADS:
        raise ValueError(f"{H} query heads: the kernel is built for {HEADS}")
    if min(B, T) < 1:
        raise ValueError(f"want B, T >= 1; got B {B}, T {T}")
    tile, smem = _SHAPE[dtype]
    splits = max(1, min(_cdiv(T, tile), _WAVES * sm_count // B))
    grid = B * splits
    if grid > _MAX_GRID:
        raise ValueError(f"{grid} blocks exceed the grid")
    return MlaPlan(B=B, H=H, T=T, threads=128, tile=tile, smem=smem, splits=splits,
                   grid=grid)


def _check(q: torch.Tensor, ckv: torch.Tensor, kr: torch.Tensor) -> tuple[int, int, int, int]:
    if q.dim() != 3 or ckv.dim() != 3 or kr.dim() != 3:
        raise ValueError(f"want q (B, H, r + rope), ckv (B, T, r), kr (B, T, rope); got "
                         f"{tuple(q.shape)}, {tuple(ckv.shape)}, {tuple(kr.shape)}")
    B, H, W = q.shape
    T, r = ckv.shape[1], ckv.shape[2]
    if ckv.shape[0] != B or kr.shape[:2] != ckv.shape[:2] or W != r + kr.shape[2]:
        raise ValueError(f"q {tuple(q.shape)}, ckv {tuple(ckv.shape)} and kr {tuple(kr.shape)} "
                         "disagree (batch, tokens, or q's width against r + rope)")
    return B, H, T, r


def mla_decode_plain(q: torch.Tensor, ckv: torch.Tensor, kr: torch.Tensor, *,
                     kv_len: int | torch.Tensor, scale: float) -> torch.Tensor:
    """The same attention as a masked softmax at float32, on the inputs'
    device (the CPU path and the kernel's yardstick on the card)."""
    B, H, T, r = _check(q, ckv, kr)
    qf = q.float() * scale
    c = ckv.float()
    s = (torch.einsum("bhr,btr->bht", qf[..., :r], c)
         + torch.einsum("bhp,btp->bht", qf[..., r:], kr.float()))
    n = torch.clamp(torch.as_tensor(kv_len, device=q.device), 1, T)
    s = s.masked_fill(torch.arange(T, device=q.device) >= n, float("-inf"))
    return torch.einsum("bht,btr->bhr", torch.softmax(s, dim=-1), c).to(q.dtype)


def mla_decode_cuda(q: torch.Tensor, ckv: torch.Tensor, kr: torch.Tensor, *,
                    kv_len: int | torch.Tensor, scale: float) -> torch.Tensor:
    """Launch the kernel on the current stream; does not synchronise.

    q, ckv and kr are contiguous, 16-byte aligned CUDA tensors of one type,
    float32 or bfloat16, with r = 512, rope = 64 and H = 16; an int
    ``kv_len`` is at least 1.  ``mla_decode_cuda.launches`` counts the
    calls (a call with more than one split also runs the merge kernel,
    counted as its part).  The kernel has no backward: under grad mode,
    inputs that require grad raise."""
    _build.check_no_grad("mla_decode_cuda", q=q, ckv=ckv, kr=kr)
    B, H, T, r = _check(q, ckv, kr)
    if (r, kr.shape[2]) != (LATENT, ROPE):
        raise ValueError(f"latent {r}, rope {kr.shape[2]}: the kernel is built for "
                         f"{LATENT}, {ROPE}")
    if ckv.dtype != q.dtype or kr.dtype != q.dtype:
        raise TypeError(f"q, ckv, kr must share a type, got {q.dtype}, {ckv.dtype}, {kr.dtype}")
    if not isinstance(kv_len, torch.Tensor) and kv_len < 1:
        raise ValueError(f"kv_len {kv_len}: a decode step sees at least its own key")
    plan = mla_plan(B, H, T, q.dtype,
                    sm_count=torch.cuda.get_device_properties(q.device).multi_processor_count)
    _build.check_cuda(plan.smem, q=q, ckv=ckv, kr=kr)
    if any(t.data_ptr() % 16 for t in (q, ckv, kr)):
        raise ValueError("the kernel reads q, ckv, kr in 16-byte units: they must be "
                         "16-byte aligned")
    len_ptr, length, len64 = _position(kv_len, T, q.device, "kv_len")
    out = q.new_empty((B, H, r))
    part = (torch.empty(B * H * plan.splits * (r + 2), dtype=torch.float32, device=q.device)
            if plan.splits > 1 else None)  # the splits' (acc, m, l)
    args = (q.data_ptr(), ckv.data_ptr(), kr.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), _DTYPES[q.dtype], B, T, H,
            plan.splits, len_ptr, length, len64, float(scale), plan.tile, plan.smem)
    _build.launch("mla_decode", "mla_decode_fwd", _ARGTYPES, args, q.device)
    mla_decode_cuda.launches += 1
    return out


mla_decode_cuda.launches = 0
# a split kernel stands for a call (its merge runs at two splits or more)
mla_decode_cuda.counters = {
    "mla_decode": ("launches", ("mla_decode_kernel", "mla_decode_mma_kernel"))}
