"""RG-LRU scan: the CUDA kernel (``csrc/rglru_scan.cu``) beside its plain
torch version.

Counterpart of the JAX package's TPU kernel ``rglru_scan_pallas``: the
Griffin recurrence

    a_t = exp(-c softplus(log_lambda) sigmoid(r_t))
    h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) sigmoid(i_t) x_t

over x, r and i of (B, S, W), float32 or bfloat16, with log_lambda (W,)
in float32 or bfloat16 and float32 arithmetic; y is h in x's type, the
final state (B, W) float32.

The kernel is a time-chunked scan: a block owns one (batch row, tile of
channels) and walks time in windows of ``n_chunks`` chunks of ``chunk``
steps, a thread a (chunk, channel); ``rglru_plan`` chooses those sizes
and the wrapper hands them to the kernel.

``rglru_scan_plain`` is ``ref.rglru_ref``'s arithmetic: the CPU path and
the kernel's yardstick on the card.  ``ops.rglru_scan`` picks between the
two by the tensors' device.  The final state follows each side's own
convention: the plain version returns h_{S-1} rounded to x's type (as the
reference oracle does), the kernel the float32 h_{S-1} (as the Pallas
kernel does when S needs no padding); at float32 the two are the same.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .ref import rglru_ref

__all__ = ["rglru_scan_cuda", "rglru_scan_plain", "rglru_plan", "RglruPlan"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 4 + [ctypes.c_float] + [_I] * 6

# The kernel's fixed sizes (as its source sets them) and the plan's limits.
_CHUNK = 16  # steps a chunk
_TILE = 32  # channels a block: a warp's lanes; warp k takes chunk k
_MAX_CHUNKS = 8  # chunks a window (the kernel takes up to 16)
_MAX_GRID = 2**31 - 1
# The H100 SXM's SMs, and the threads each holds at the 16-byte-copy
# kernel's 64 registers (65536 an SM).  A block walks the whole time axis,
# so the plan sizes windows to keep the grid resident at once; it takes a
# power of two of chunks, which divides the usual S (PERF.md has the
# variants' times).
_SMS = 132
_THREADS_PER_SM = 1024


@dataclass(frozen=True)
class RglruPlan:
    """One launch of ``csrc/rglru_scan.cu`` for x (B, S, W).

    Block i takes batch row and channels ``block(i)``, ``tile`` (32)
    channels, for the whole time axis, which it walks in ``n_windows``
    windows of ``n_chunks`` chunks of ``chunk`` steps; its thread j takes
    chunk and channel ``thread(j)`` of every window (a warp a chunk).
    Two windows are staged in shared memory at once (the one computed and
    the next), by 16-byte copies of ``vec`` elements; with ``vec`` 1 (W or
    a pointer not 16-byte aligned) each lane reads its own channel from
    device memory instead.
    """

    B: int
    S: int
    W: int
    tile: int
    chunk: int
    n_chunks: int
    vec: int
    esize: int  # bytes an element of x, r, i and y

    @property
    def window(self) -> int:
        return self.n_chunks * self.chunk

    @property
    def threads(self) -> int:
        return self.tile * self.n_chunks

    @property
    def tiles(self) -> int:
        return -(-self.W // self.tile)

    @property
    def grid(self) -> int:
        return self.B * self.tiles

    @property
    def n_windows(self) -> int:
        return -(-self.S // self.window)

    @property
    def smem(self) -> int:
        """Shared-memory bytes a block: two staged windows of x, r and i
        (with 16-byte copies only), and the chunks' (P, H) and the entering
        state of two windows."""
        ring = 2 * 3 * self.window * self.tile * self.esize if self.vec > 1 else 0
        return ring + 2 * 8 * self.n_chunks * self.tile + 2 * 4 * self.tile

    def block(self, i: int) -> tuple[int, int]:
        """(batch row, first channel) of block i, as the kernel decodes it."""
        return i // self.tiles, i % self.tiles * self.tile

    def thread(self, j: int) -> tuple[int, int]:
        """(chunk, channel within the tile) of thread j."""
        return j // self.tile, j % self.tile

    def steps(self, w: int, k: int) -> range:
        """The steps chunk k of window w takes (those before S)."""
        t0 = w * self.window + k * self.chunk
        return range(t0, min(t0 + self.chunk, self.S))


def rglru_plan(B: int, S: int, W: int, dtype: torch.dtype, *,
               aligned: bool = True) -> RglruPlan:
    """The kernel's launch for x, r, i (B, S, W) of ``dtype``; ``aligned``
    says that the three inputs' pointers are 16-byte aligned.  A window
    holds the largest power of two of 16-step chunks that keeps the whole
    grid resident on the card, at most 8 and no more than S needs."""
    if dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {dtype}")
    esize = 4 if dtype == torch.float32 else 2
    per_copy = 16 // esize
    grid = B * -(-W // _TILE)
    most = min(_MAX_CHUNKS, -(-S // _CHUNK), _SMS * _THREADS_PER_SM // (_TILE * max(grid, 1)))
    n_chunks = 1 << (max(most, 1).bit_length() - 1)
    plan = RglruPlan(B=B, S=S, W=W, tile=_TILE, chunk=_CHUNK, n_chunks=n_chunks,
                     vec=per_copy if aligned and W % per_copy == 0 else 1, esize=esize)
    if plan.smem > _build.MAX_SMEM or plan.grid > _MAX_GRID:
        raise ValueError(f"a block needs {plan.smem} bytes of shared memory, the grid "
                         f"{plan.grid} blocks")
    return plan


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


def _launch(x, r_gate, i_gate, log_lambda, y, st, c: float, plan: RglruPlan) -> None:
    """One launch of the kernel at ``plan`` (the wrapper's checks done)."""
    _build.launch("rglru_scan", "rglru_scan_fwd", _ARGTYPES, (
        x.data_ptr(), r_gate.data_ptr(), i_gate.data_ptr(), log_lambda.data_ptr(),
        y.data_ptr(), st.data_ptr(), _DTYPES[x.dtype], _DTYPES[log_lambda.dtype],
        plan.S, plan.W, float(c), plan.grid, plan.threads, plan.chunk, plan.n_chunks,
        int(plan.vec > 1), plan.smem,
    ), x.device)


def rglru_scan_cuda(x, r_gate, i_gate, log_lambda, *, c: float = 8.0,
                    return_state: bool = False):
    """Launch the CUDA kernel on the current stream; does not synchronise.

    x, r and i are contiguous CUDA tensors of one type, float32 or
    bfloat16; log_lambda is float32 or bfloat16.  Returns y, or
    ``(y, float32 h_{S-1})``.  ``rglru_scan_cuda.launches`` counts the
    launches made (an empty ``B * W`` or ``S`` returns empty outputs, a
    zero state, and launches nothing).  The kernel has no backward: under
    grad mode, inputs that require grad raise.
    """
    _build.check_no_grad("rglru_scan_cuda", x=x, r_gate=r_gate, i_gate=i_gate,
                         log_lambda=log_lambda)
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
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, r_gate, i_gate))
    _launch(x, r_gate, i_gate, log_lambda, y, st, c, rglru_plan(B, S, W, x.dtype, aligned=aligned))
    rglru_scan_cuda.launches += 1
    return (y, st) if return_state else y


rglru_scan_cuda.launches = 0
rglru_scan_cuda.counters = {"rglru_scan": ("launches", ("rglru_chunk_scan_kernel",))}
