"""RG-LRU scan: the CUDA kernel (``csrc/rglru_scan.cu``) beside its plain
torch version.

Counterpart of the JAX package's TPU kernel ``rglru_scan_pallas``: the
Griffin recurrence

    a_t = exp(-c softplus(log_lambda) sigmoid(r_t))
    h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) sigmoid(i_t) x_t

over x, r and i of (B, S, W), float32 or bfloat16, with log_lambda (W,)
in float32 or bfloat16 and float32 arithmetic; y is h in x's type, the
final state (B, W) float32.

``rglru_scan_plain`` is ``ref.rglru_ref``'s arithmetic: the CPU path and
the kernel's yardstick on the card.  ``ops.rglru_scan`` picks between the
two by the tensors' device.  The final state follows each side's own
convention: the plain version returns h_{S-1} rounded to x's type (as the
reference oracle does), the kernel the float32 h_{S-1} (as the Pallas
kernel does when S needs no padding); at float32 the two are the same.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import rglru_ref

__all__ = ["rglru_scan_cuda", "rglru_scan_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float]


def _check(x, r_gate, i_gate, log_lambda) -> tuple[int, int, int]:
    if x.dim() != 3 or r_gate.shape != x.shape or i_gate.shape != x.shape:
        raise ValueError(f"want x = r = i (B,S,W); got {tuple(x.shape)}, "
                         f"{tuple(r_gate.shape)}, {tuple(i_gate.shape)}")
    B, S, W = x.shape
    if tuple(log_lambda.shape) != (W,):
        raise ValueError(f"log_lambda {tuple(log_lambda.shape)} must be ({W},)")
    return B, S, W


def rglru_scan_plain(x, r_gate, i_gate, log_lambda, *, c: float = 8.0,
                     return_state: bool = False):
    """The scan in plain torch ops (``ref.rglru_ref``), on the inputs'
    device.  Returns y, or ``(y, h_{S-1} rounded to x's type, as float32)``."""
    _check(x, r_gate, i_gate, log_lambda)
    return rglru_ref(x, r_gate, i_gate, log_lambda, c=c, return_state=return_state)


def rglru_scan_cuda(x, r_gate, i_gate, log_lambda, *, c: float = 8.0,
                    return_state: bool = False):
    """Launch the CUDA kernel on the current stream; does not synchronise.

    x, r and i are contiguous CUDA tensors of one type, float32 or
    bfloat16; log_lambda is float32 or bfloat16.  Returns y, or
    ``(y, float32 h_{S-1})``.  ``rglru_scan_cuda.launches`` counts the
    launches made (an empty ``B * W`` or ``S`` returns empty outputs, a
    zero state, and launches nothing).
    """
    B, S, W = _check(x, r_gate, i_gate, log_lambda)
    _build.check_cuda(0, x=x, r_gate=r_gate, i_gate=i_gate, log_lambda=log_lambda)
    if x.dtype not in _DTYPES or r_gate.dtype != x.dtype or i_gate.dtype != x.dtype:
        raise TypeError(f"x, r, i must share float32 or bfloat16, got {x.dtype}, "
                        f"{r_gate.dtype}, {i_gate.dtype}")
    if log_lambda.dtype not in _DTYPES:
        raise TypeError(f"log_lambda must be float32 or bfloat16, got {log_lambda.dtype}")
    y = torch.empty_like(x)
    st = torch.empty((B, W), dtype=torch.float32, device=x.device)
    if B * W == 0 or S == 0:
        st.zero_()
        return (y, st) if return_state else y
    _build.launch("rglru_scan", "rglru_scan_fwd", _ARGTYPES, (
        x.data_ptr(), r_gate.data_ptr(), i_gate.data_ptr(), log_lambda.data_ptr(),
        y.data_ptr(), st.data_ptr(), _DTYPES[x.dtype], _DTYPES[log_lambda.dtype],
        B, S, W, float(c),
    ), x.device)
    rglru_scan_cuda.launches += 1
    return (y, st) if return_state else y


rglru_scan_cuda.launches = 0
