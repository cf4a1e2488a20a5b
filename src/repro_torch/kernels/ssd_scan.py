"""Mamba-2 SSD scan: the CUDA kernel (``csrc/ssd_scan.cu``) beside its plain
torch version.

Counterpart of the JAX package's TPU kernel ``ssd_scan_pallas``: the
chunked dual form of the SSD recurrence (intra-chunk masked quadratic
products, inter-chunk contribution of the carried state, the state update
and the D skip), with a float32 final state.  x is (B, S, nh, hp), dt
(B, S, nh) with softplus applied, A and D (nh,), B and C (B, S, ng, ds)
with ng dividing nh; y has x's shape and type, the final state is
(B, nh, ds, hp) float32.

``ssd_scan_plain`` is ``ref.ssd_chunked_ref``'s arithmetic: the CPU path
and the kernel's yardstick on the card.  ``ops.ssd_scan`` picks between
the two by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ssd_chunked_ref

__all__ = ["ssd_scan_cuda", "ssd_scan_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HP = 128  # the widest head the kernel's output registers hold
_TILE = 32  # chunk rows a tile, as in the kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I]


def _check(x, dt, A, Bm, Cm, D, chunk: int) -> tuple[int, ...]:
    if x.dim() != 4 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"want x (B,S,nh,hp), B = C (B,S,ng,ds); got {tuple(x.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    Bb, S, nh, hp = x.shape
    ng, ds = Bm.shape[2], Bm.shape[3]
    if Bm.shape[:2] != (Bb, S) or tuple(dt.shape) != (Bb, S, nh):
        raise ValueError(f"dt {tuple(dt.shape)} / B {tuple(Bm.shape)} disagree with x "
                         f"{tuple(x.shape)}")
    if tuple(A.shape) != (nh,) or tuple(D.shape) != (nh,):
        raise ValueError(f"A {tuple(A.shape)} and D {tuple(D.shape)} must be ({nh},)")
    if ng == 0 or nh % ng:
        raise ValueError(f"nh = {nh} is not a multiple of ng = {ng}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"S = {S} is not a multiple of chunk = {chunk}")
    return Bb, S, nh, hp, ng, ds


def ssd_scan_plain(x, dt, A, Bm, Cm, D, *, chunk: int, return_state: bool = False):
    """The scan in plain torch ops (``ref.ssd_chunked_ref``), on the inputs'
    device."""
    _check(x, dt, A, Bm, Cm, D, chunk)
    return ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk, return_state=return_state)


def _smem_bytes(hp: int, ds: int, chunk: int) -> int:
    """Shared memory one block of the kernel takes (``smem_bytes`` in the
    source computes the same)."""
    return 4 * (ds * hp + 2 * _TILE * (ds + 1) + _TILE * hp + _TILE * (_TILE + 1) + 2 * chunk)


def ssd_scan_cuda(x, dt, A, Bm, Cm, D, *, chunk: int, return_state: bool = False):
    """Launch the CUDA kernel on the current stream; does not synchronise.

    x, B and C are contiguous CUDA tensors of one type, float32 or
    bfloat16; A and D are float32; dt is float32 or x's type (a bfloat16 dt
    is widened to float32 first, as the kernel reads it).
    ``ssd_scan_cuda.launches`` counts the launches made (an empty ``B * nh``
    or ``S`` returns empty outputs and launches nothing).
    """
    Bb, S, nh, hp, ng, ds = _check(x, dt, A, Bm, Cm, D, chunk)
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, B, C must share float32 or bfloat16, got {x.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}")
    if A.dtype != torch.float32 or D.dtype != torch.float32:
        raise TypeError(f"A and D must be float32, got {A.dtype}, {D.dtype}")
    if dt.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"dt must be float32 or {x.dtype}, got {dt.dtype}")
    if hp > _MAX_HP:
        raise ValueError(f"head width hp = {hp} exceeds the kernel's {_MAX_HP}")
    _build.check_cuda(_smem_bytes(hp, ds, chunk), x=x, dt=dt, A=A, B=Bm, C=Cm, D=D)
    dt = dt.float()  # no copy when dt is float32 already
    y = torch.empty_like(x)
    st = torch.empty((Bb, nh, ds, hp), dtype=torch.float32, device=x.device)
    if Bb * nh == 0 or S == 0:
        st.zero_()
        return (y, st) if return_state else y
    _build.launch("ssd_scan", "ssd_scan_fwd", _ARGTYPES, (
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
        y.data_ptr(), st.data_ptr(), _DTYPES[x.dtype], Bb, S, nh, hp, ng, ds, chunk,
    ), x.device)
    ssd_scan_cuda.launches += 1
    return (y, st) if return_state else y


ssd_scan_cuda.launches = 0
