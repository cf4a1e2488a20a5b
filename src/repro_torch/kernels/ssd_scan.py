"""Mamba-2 SSD scan: two CUDA kernels beside their plain torch version.

bfloat16 inputs run on the tensor cores with the chunks in parallel
(``csrc/ssd_scan_mma.cu``: chunk, score, state and output passes, the
products on mma.sync), float32 inputs on the CUDA cores (``csrc/ssd_scan.cu``),
whose 2e-5 tolerance rules out bf16 and TF32 operands.

Counterpart of the JAX package's TPU kernel ``ssd_scan_pallas``: the
chunked dual form of the SSD recurrence (intra-chunk masked quadratic
products, inter-chunk contribution of the carried state, the state update
and the D skip), with a float32 final state.  x is (B, S, nh, hp), dt
(B, S, nh) with softplus applied, A and D (nh,), B and C (B, S, ng, ds)
with ng dividing nh; y has x's shape and type, the final state is
(B, nh, ds, hp) float32.

``ssd_scan_plain`` is ``ref.ssd_chunked_ref``'s arithmetic: the CPU path
and the kernels' yardstick on the card.  ``ops.ssd_scan`` picks it or
``ssd_scan_cuda`` by the tensors' device.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .ref import ssd_chunked_ref

__all__ = ["ssd_scan_cuda", "ssd_scan_plain", "mma_plan", "MmaPlan"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HP = 128  # the widest head the kernel's output registers hold
_TILE = 32  # chunk rows a tile, as in the kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I]
_MMA_ARGTYPES = [_P] * 12 + [_I] * 12

# The tensor-core kernel's tiles, as its source sets them.
_MMA_WARPS = 4  # score and output passes
_MMA_ROWS = 16 * _MMA_WARPS  # positions a tile
_MMA_KD = 64  # states (ds) a staged slice in the score and output passes
_MMA_CHUNK_WARPS = 8  # chunk pass
_MMA_GROUP = 16 * _MMA_CHUNK_WARPS  # states a group in the chunk pass
_MMA_STATE_THREADS = 256
_MMA_HEAD_PADS = (16, 32, 64, 128)  # hp pads to the first of these at or above it
_MAX_GRID = 2**31 - 1


@dataclass(frozen=True)
class MmaPlan:
    """The four launches of ``ssd_scan_mma.cu`` for one call.

    Chunk pass: block i takes (b, chunk, head) ``chunk_block(i)``, the
    states in ``groups()`` and the positions in tiles of ``rows``.  Score
    pass: block i takes one tile of ``rows`` positions t of one (b, chunk,
    B/C group), ``score_block(i)``, against every source tile at or below
    it: ``n_pairs`` score tiles a (b, chunk, group).  State pass: a thread
    two neighbouring elements (b, head, state, column < ``hp_pad``).  Output pass: block i
    takes ``rows`` positions of one (b, chunk, head), ``out_block(i)``.
    The score and output grids run the tiles with the most source tiles
    first; their products run over the states in ``slices()``.
    """

    B: int
    nh: int
    ng: int
    hp: int
    ds: int
    chunk: int
    n_chunks: int
    hp_pad: int  # hp padded to a width the kernel is built for
    rows: int
    kd: int
    group: int
    threads: int  # score and output passes
    chunk_threads: int
    n_tiles: int  # position tiles of a chunk
    n_pairs: int  # score tiles (t tile, s tile <= t tile) of a chunk
    chunk_grid: int
    chunk_smem: int  # dynamic shared-memory bytes a block of each pass
    score_grid: int
    score_smem: int
    state_threads: int
    state_grid: int
    out_grid: int
    out_smem: int

    def chunk_block(self, i: int) -> tuple[int, int, int]:
        """(b, chunk, head) of chunk-pass block i, as the kernel decodes it."""
        return i // self.nh // self.n_chunks, i // self.nh % self.n_chunks, i % self.nh

    def score_block(self, i: int) -> tuple[int, int, int, int]:
        """(b, chunk, group, first position in the chunk) of score-pass block i."""
        per = self.B * self.n_chunks * self.ng
        j = i % per
        return (j // self.ng // self.n_chunks, j // self.ng % self.n_chunks, j % self.ng,
                (self.n_tiles - 1 - i // per) * self.rows)

    def out_block(self, i: int) -> tuple[int, int, int, int]:
        """(b, chunk, head, first position in the chunk) of output-pass block i."""
        per = self.B * self.n_chunks * self.nh
        b, c, h = self.chunk_block(i % per)
        return b, c, h, (self.n_tiles - 1 - i // per) * self.rows

    def slices(self) -> list[tuple[int, int]]:
        """(first state, states) of each slice of the score and output passes."""
        return [(k0, min(self.kd, self.ds - k0)) for k0 in range(0, self.ds, self.kd)]

    def groups(self) -> list[tuple[int, int]]:
        """(first state, states) of each group of the chunk pass."""
        return [(d0, min(self.group, self.ds - d0)) for d0 in range(0, self.ds, self.group)]


def mma_plan(B: int, S: int, nh: int, hp: int, ng: int, ds: int, chunk: int) -> MmaPlan:
    """The tensor-core kernel's launches for x (B, S, nh, hp) and B, C
    (B, S, ng, ds), in chunks of ``chunk``."""
    if hp > _MAX_HP:
        raise ValueError(f"head width hp = {hp} exceeds the kernel's {_MAX_HP}")
    hp_pad = next(w for w in _MMA_HEAD_PADS if w >= hp)
    rows, kd, group = _MMA_ROWS, _MMA_KD, _MMA_GROUP
    row_bytes = 2 * hp_pad + 16  # a bf16 row of x or of a state slice, padded by 16 bytes
    k_bytes = 2 * kd + 16  # a bf16 row of a C or B slice, padded
    n_chunks = S // chunk
    n_tiles = -(-chunk // rows)
    return MmaPlan(
        B=B, nh=nh, ng=ng, hp=hp, ds=ds, chunk=chunk, n_chunks=n_chunks, hp_pad=hp_pad,
        rows=rows, kd=kd, group=group, threads=32 * _MMA_WARPS,
        chunk_threads=32 * _MMA_CHUNK_WARPS, n_tiles=n_tiles,
        n_pairs=n_tiles * (n_tiles + 1) // 2, chunk_grid=B * n_chunks * nh,
        chunk_smem=2 * (rows * (2 * group + 16) + rows * row_bytes + 4 * rows)
        + 2 * rows * row_bytes + 4 * _MMA_CHUNK_WARPS + 4 * chunk,
        score_grid=n_tiles * B * n_chunks * ng, score_smem=2 * 2 * rows * k_bytes,
        state_threads=_MMA_STATE_THREADS,
        state_grid=-(-B * nh * ds * hp_pad // (2 * _MMA_STATE_THREADS)),
        out_grid=n_tiles * B * n_chunks * nh,
        out_smem=2 * (rows * k_bytes + 2 * kd * row_bytes) + 2 * rows * row_bytes + 4 * 5 * rows,
    )


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
    """Launch a CUDA kernel on the current stream; does not synchronise.

    x, B and C are contiguous CUDA tensors of one type: bfloat16 runs the
    tensor-core kernel (four launches), float32 the CUDA-core one.  A and
    D are float32; dt is float32 or x's type (a bfloat16 dt is widened to
    float32 first, as the kernels read it).  ``ssd_scan_cuda.launches``
    counts the calls that launched either kernel,
    ``ssd_scan_cuda.mma_launches`` those on the tensor-core kernel (an
    empty ``B * nh`` or ``S`` returns empty outputs and launches nothing).
    The kernels have no backward: under grad mode, inputs that require grad
    raise.
    """
    _build.check_no_grad("ssd_scan_cuda", x=x, dt=dt, A=A, B=Bm, C=Cm, D=D)
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
    mma = x.dtype == torch.bfloat16
    if mma:
        plan = mma_plan(Bb, S, nh, hp, ng, ds, chunk)
        if max(plan.out_grid, plan.state_grid) > _MAX_GRID:
            raise ValueError(f"{plan.out_grid} output blocks or {plan.state_grid} state blocks "
                             f"exceed the grid")
        smem = max(plan.chunk_smem, plan.score_smem, plan.out_smem)
    else:
        smem = _smem_bytes(hp, ds, chunk)
    _build.check_cuda(smem, x=x, dt=dt, A=A, B=Bm, C=Cm, D=D)
    dt = dt.float()  # no copy when dt is float32 already
    y = torch.empty_like(x)
    st = torch.empty((Bb, nh, ds, hp), dtype=torch.float32, device=x.device)
    if Bb * nh == 0 or S == 0:
        st.zero_()
        return (y, st) if return_state else y
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
            y.data_ptr(), st.data_ptr())
    if mma:
        f32 = dict(dtype=torch.float32, device=x.device)
        cum = torch.empty((Bb, nh, S), **f32)
        sc = torch.empty((Bb, plan.n_chunks, nh, ds, hp), **f32)
        # scores: the score pass fills them, or with no state (ds 0) they are zero
        scores = (torch.empty if ds else torch.zeros)(
            (Bb, plan.n_chunks, ng, plan.n_pairs, plan.rows * plan.rows), **f32)
        hbuf = torch.empty((2, Bb, plan.n_chunks, nh, ds, plan.hp_pad), dtype=torch.bfloat16,
                           device=x.device)
        vec = hp % 8 == 0 and ds % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, Bm, Cm))
        _build.launch("ssd_scan_mma", "ssd_scan_mma_fwd", _MMA_ARGTYPES, (
            *ptrs, cum.data_ptr(), sc.data_ptr(), scores.data_ptr(), hbuf.data_ptr(), Bb, S, nh,
            hp, ng, ds, chunk, plan.hp_pad, plan.chunk_smem, plan.score_smem, plan.out_smem,
            int(vec),
        ), x.device)
        ssd_scan_cuda.mma_launches += 1
    else:
        _build.launch("ssd_scan", "ssd_scan_fwd", _ARGTYPES, (
            *ptrs, _DTYPES[x.dtype], Bb, S, nh, hp, ng, ds, chunk,
        ), x.device)
    ssd_scan_cuda.launches += 1
    return (y, st) if return_state else y


ssd_scan_cuda.launches = 0
ssd_scan_cuda.mma_launches = 0
# the bf16 scan runs four passes; its output pass, once a call, stands for it
ssd_scan_cuda.counters = {
    "ssd_scan": ("launches", ("ssd_scan_kernel", "ssd_out_kernel")),
    "ssd_scan_mma": ("mma_launches", ("ssd_out_kernel",)),
}
