"""Flash attention: two CUDA kernels beside their plain torch version.

bfloat16 inputs run on the tensor cores (``csrc/flash_attention_mma.cu``:
mma.sync on GQA-packed query tiles), float32 inputs on the CUDA cores
(``csrc/flash_attention.cu``), whose 2e-5 tolerance rules out bf16 and
TF32 operands.

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
from dataclasses import dataclass

import torch

from . import _build
from .ref import attention_ref

__all__ = ["flash_attention_cuda", "flash_attention_plain", "mma_plan", "MmaPlan", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128, 256)  # the head widths the kernels are built for
_MAX_GRID_Y = 65535  # the float32 kernel's grid: (query tiles, B * H)
_MAX_GRID_X = 2**31 - 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F]
_MMA_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I]

# The tensor-core kernel's tiles, as ``Shape`` in its source sets them.
_MMA_WARPS = 4
_MMA_ROWS = 16 * _MMA_WARPS  # packed query rows a block: 16 a warp


@dataclass(frozen=True)
class MmaPlan:
    """The launch of ``flash_attention_mma.cu`` for one call.

    Packed row r of kv head kh stands for query position ``r // group`` of
    query head ``kh * group + r % group``; a block takes ``rows`` packed
    rows of one (b, kv head), and block i the ``i // (B * K)``-th longest
    tile, so the grid runs the longest causal tiles first.
    """

    B: int
    K: int
    group: int  # query heads a kv head: G = H / K
    rows: int  # packed query rows a block
    kv_tile: int  # keys a staged K / V tile
    threads: int
    smem: int  # dynamic shared-memory bytes a block: Q and two K and two V tiles
    n_tiles: int  # row tiles of one (b, kv head)
    grid: int  # blocks, on a 1-D grid

    def block(self, i: int) -> tuple[int, int, int]:
        """(b, kv head, first packed row) of block i, as the kernel decodes it."""
        tile = self.n_tiles - 1 - i // (self.B * self.K)
        bk = i % (self.B * self.K)
        return bk // self.K, bk % self.K, tile * self.rows

    def row(self, kh: int, r: int) -> tuple[int, int]:
        """(query position, query head) of packed row r of kv head kh."""
        return r // self.group, kh * self.group + r % self.group


def mma_plan(B: int, S: int, H: int, K: int, hd: int) -> MmaPlan:
    """The tensor-core kernel's launch for q (B, S, H, hd) against kv heads K."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one the kernel is built for {HEAD_DIMS}")
    kv_tile = 32 if hd >= 256 else 64  # two blocks an SM at hd 256
    row_bytes = 2 * hd + 16  # a bf16 row padded by 16 bytes against bank conflicts
    group = H // K
    n_tiles = -(-S * group // _MMA_ROWS)
    return MmaPlan(B=B, K=K, group=group, rows=_MMA_ROWS, kv_tile=kv_tile,
                   threads=32 * _MMA_WARPS, smem=(_MMA_ROWS + 4 * kv_tile) * row_bytes,
                   n_tiles=n_tiles, grid=n_tiles * B * K)


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
    scale: float | None = None,
) -> torch.Tensor:
    """The same attention as a masked softmax at float32, on the inputs'
    device.  A row with no visible key averages every value (a softmax over
    -1e30), where the kernel averages the values of the tiles it visited;
    a causal prefill has no such row."""
    _check(q, k, v)
    return attention_ref(q, k, v, q_offset=q_offset, causal=causal, window=window, scale=scale)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Launch a CUDA kernel on the current stream; does not synchronise.

    q, k and v are contiguous CUDA tensors of one type with a head dim in
    ``HEAD_DIMS``: bfloat16 (16-byte aligned) runs the tensor-core kernel,
    float32 the CUDA-core one.  ``flash_attention_cuda.launches`` counts
    the launches of either, ``flash_attention_cuda.mma_launches`` those of
    the tensor-core kernel (an empty ``B * H * S`` returns an empty output
    and launches nothing; ``T == 0`` raises).  Scores are scaled by
    ``scale``, 1 / sqrt(hd) if None.  The kernel has no backward:
    under grad mode, inputs that require grad raise.
    """
    _build.check_no_grad("flash_attention_cuda", q=q, k=k, v=v)
    B, S, H, K, T, hd = _check(q, k, v)
    _build.check_cuda(0, q=q, k=k, v=v)
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one the kernel is built for {HEAD_DIMS}")
    if T == 0:
        raise ValueError("attention over an empty key sequence")
    mma = q.dtype == torch.bfloat16
    if mma:
        plan = mma_plan(B, S, H, K, hd)
        if plan.grid > _MAX_GRID_X or S * plan.group > _MAX_GRID_X - plan.rows:
            raise ValueError(f"{plan.grid} blocks of {plan.rows} packed rows exceed the grid")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("the tensor-core kernel reads q, k, v in 16-byte units: "
                             "they must be 16-byte aligned")
        _build.check_cuda(plan.smem, q=q)
    elif B * H > _MAX_GRID_Y:
        raise ValueError(f"B * H = {B * H} exceeds the grid's y extent {_MAX_GRID_Y}")
    out = torch.empty_like(q)
    if B * H * S == 0:
        return out  # a grid of zero blocks is a launch error
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T, H, K, hd,
              int(q_offset), int(bool(causal)), int(window),
              1.0 / math.sqrt(hd) if scale is None else float(scale))
    if mma:
        _build.launch("flash_attention_mma", "flash_attention_mma_fwd", _MMA_ARGTYPES,
                      (*common, plan.rows, plan.kv_tile, plan.smem), q.device)
        flash_attention_cuda.mma_launches += 1
    else:
        _build.launch("flash_attention", "flash_attention_fwd", _ARGTYPES, common, q.device)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.mma_launches = 0
