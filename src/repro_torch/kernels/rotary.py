"""Rotary position embedding of q and k (RoPE, and Qwen2-VL's multimodal
M-RoPE) as one CUDA kernel a call (``csrc/rotary.cu``, kernel 8) beside
its plain torch version, ``layers.apply_rope`` / ``apply_mrope`` on each.

q (B, S, Hq, D) and k (B, S, Hk, D) share their positions: (B, S) for
RoPE (``sections`` None: one section of all D / 2 frequency slots), or
(B, S, len(sections)) for M-RoPE, slot i rotating by the position stream
of the section that holds it.  The kernel rotates both tensors in place,
in one launch, in their own type (float32 or bfloat16), computing what the
plain route computes with its roundings in the same places: the inverse
frequencies, the angles and the rotation in float32, one rounding to the
input's type.

It reads q and k through their batch, row and head strides (the last axis
dense), so a slice of a wider tensor is rotated where it lies, and the
positions through theirs as int32 or int64 on the card: a decode step's
0-d position expanded to (B, 1) or (B, 1, 3) is read with no copy and no
host read, so the launch runs inside a captured graph.  CPU tensors take
``rotary_plain``, which returns new tensors and leaves q and k as they
were.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rotary_cuda", "rotary_plain", "MAX_HALF", "MAX_SECTIONS"]

MAX_HALF, MAX_SECTIONS = 256, 4  # the kernel's shared angle table and section table
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P, _L, _L, _L, _I, _P, _L, _L, _L, _I, _I, _I, _I, _I, _I,
             _P, _L, _L, _L, _I, _I, _I, _I, _I, ctypes.c_float]


def _check(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
           sections: tuple[int, ...] | None) -> tuple[int, int, int, tuple[int, ...]]:
    """(B, S, half, sections) of a call; raises on what the kernel does not
    take."""
    if q.dim() != 4 or k.dim() != 4 or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"want q (B, S, Hq, D) and k (B, S, Hk, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, S, _, D = q.shape
    if D % 2:
        raise ValueError(f"rotary width {D} is odd: the rotation pairs its halves")
    half = D // 2
    secs = (half,) if sections is None else tuple(int(n) for n in sections)
    if sum(secs) != half or min(secs) < 1:
        raise ValueError(f"sections {secs} do not cover the {half} frequency slots")
    if len(secs) > MAX_SECTIONS or half > MAX_HALF:
        raise ValueError(f"{len(secs)} sections over {half} slots: the kernel takes at most "
                         f"{MAX_SECTIONS} sections and {MAX_HALF} slots")
    want = (B, S) if sections is None else (B, S, len(secs))
    if tuple(positions.shape) != want:
        raise ValueError(f"positions {tuple(positions.shape)} do not fit q and k: want {want}")
    if positions.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"positions must be int32 or int64, got {positions.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1:
        raise ValueError("q and k must be dense along their last axis")
    if q.dtype not in _DTYPES or k.dtype != q.dtype:
        raise TypeError(f"the rotary kernel runs float32 or bfloat16 q and k of one type, got "
                        f"{q.dtype}, {k.dtype}")
    return B, S, half, secs


def rotary_plain(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, theta: float,
                 sections: tuple[int, ...] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """q and k rotated by ``layers.apply_rope`` (``sections`` None) or
    ``apply_mrope``: new tensors, on the inputs' device (the CPU path, the
    ``attn_impl="xla"`` route and the kernel's yardstick on the card)."""
    from ..models.layers import apply_mrope, apply_rope

    if sections is None:
        return apply_rope(q, positions, theta), apply_rope(k, positions, theta)
    return apply_mrope(q, positions, theta, sections), apply_mrope(k, positions, theta, sections)


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """Batch, row and head strides in elements; 0 along an axis of one."""
    return tuple(st if n > 1 else 0 for n, st in zip(t.shape[:3], t.stride()[:3], strict=True))


def _vec(half: int, *tensors: torch.Tensor) -> int:
    """Elements a thread loads at once: 16 bytes' worth where every row
    and head of the tensors starts 16-byte aligned and the half width is
    whole 16-byte units, else 1."""
    v = 16 // tensors[0].element_size()
    aligned = all(t.data_ptr() % 16 == 0 and all(st % v == 0 for st in _strides(t))
                  for t in tensors)
    return v if aligned and half % v == 0 else 1


def rotary_cuda(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate q and k in place on the current stream, one launch; returns
    them.  Does not synchronise.  ``rotary_cuda.launches`` counts the
    launches.  The kernel has no backward: under grad mode, inputs that
    require grad raise."""
    _build.check_no_grad("rotary_cuda", q=q, k=k)
    B, S, half, secs = _check(q, k, positions, sections)
    for name, t in (("q", q), ("k", k), ("positions", positions)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"the rotary kernel needs q, k and positions on one CUDA device, "
                             f"got {name} on {t.device}")
    if B * S == 0:
        return q, k
    if B * S > 2**31 - 1:
        raise ValueError(f"{B * S} token rows exceed the grid")
    pad = (*secs, *(0,) * (MAX_SECTIONS - len(secs)))
    pb, ps = positions.stride(0), positions.stride(1)
    pj = positions.stride(2) if sections is not None else 0
    args = (q.data_ptr(), *_strides(q), q.shape[2], k.data_ptr(), *_strides(k), k.shape[2],
            B, S, half, _DTYPES[q.dtype], _vec(half, q, k),
            positions.data_ptr(), pb, ps, pj, int(positions.dtype == torch.int64), *pad,
            float(theta))
    _build.launch("rotary", "rotary_fwd", _ARGTYPES, args, q.device)
    rotary_cuda.launches += 1
    return q, k


rotary_cuda.launches = 0
