"""Alg-2 TFS-block placement sweeps: the CUDA kernels and their plain versions.

The port of ``placement_sweep_pallas`` and ``placement_sweep_batch_pallas``
(the JAX package's ``kernels/placement_step.py``).

Single instance: a ``(B, n_t)`` float64 shares block with the ``(n_t,)``
per-task initialization intervals and the ``(n_f,)`` per-device capacity /
reconfiguration tables gives ``(feasible, placed_tasks, n_splits,
devices_used)`` as ``(B,)`` tensors (bool, int32, int32, int32):

* :func:`placement_sweep_plain` — the sweep in torch ops, one masked
  carry/split step over all rows per iteration; runs on any device.  The
  CPU tests and the ``"torch"`` engine use it.
* :func:`placement_sweep_cuda` — the hand-written kernel
  (``csrc/placement_sweep.cu``), one thread per row, CUDA tensors only.

Fleet-parallel: a ``(B, R, n_t)`` stack of B instances' blocks, padded to
common widths, with per-instance tables ``iis (B, n_t)``, ``t_slr`` /
``t_cfg (B, n_f)`` and int32 live counts ``n_t_eff`` / ``n_f_eff (B,)``,
gives the same four outputs as ``(B, R)`` tensors:

* :func:`placement_sweep_batch_plain` — the plain version;
* :func:`placement_sweep_batch_cuda` — the hand-written kernel
  (``csrc/placement_sweep_batch.cu``), one thread per row.

Both kernels share one row loop and one tiling (``csrc/placement_sweep.cuh``)
of the flattened ``B * R`` rows, 32 rows a warp; :func:`sweep_plan` sizes
the launch (warps a block, staged row stride, instances a tile, copy
width, shared memory, staged or direct path, grid) and the launchers take
its fields, so the mapping of rows to blocks, warps and lanes is pure
Python the CPU tests check.  Kernel 1 is the batched kernel's tiling over
a stack of one instance.

All four replay the scalar oracle's float64 operations in the same order,
so kernel and plain version agree bit for bit.  Degenerate ``n_t == 0`` /
``n_f == 0`` widths are the caller's (``placement_backends.base``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import torch

from . import _build

__all__ = [
    "placement_sweep_plain",
    "placement_sweep_cuda",
    "placement_sweep_batch_plain",
    "placement_sweep_batch_cuda",
    "sweep_plan",
    "SweepPlan",
]

_PLACE_EPS = 1e-9  # == repro_torch.core.placement._EPS
_INT_MAX = 2**31 - 1  # the launchers take B and R as C ints

# The tiling's sizes (csrc/placement_sweep.cuh) and the H100's per-SM
# resources the plan sizes residency by: 2048 threads, 32 blocks and 228 KB
# of shared memory an SM (1 KB of it reserved a block), 65536 registers,
# at most 64 a thread (the kernels' __launch_bounds__(256, 4)).
_TILE = 32  # rows a tile: a warp's, one row a lane
_MAX_WARPS = 8  # warps a block
_MAX_GRID = 2**31 - 1
_SM_THREADS = 2048
_SM_BLOCKS = 32
_SM_SMEM = 233_472
_BLOCK_RESERVED = 1024
_SM_REGS = 65_536
_REGS_A_THREAD = 64


def _resident(threads: int, smem: int) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes one SM holds at once."""
    by_smem = _SM_SMEM // (smem + _BLOCK_RESERVED) if smem else _SM_BLOCKS
    return min(_SM_BLOCKS, _SM_THREADS // threads, _SM_REGS // (_REGS_A_THREAD * threads),
               by_smem)


@dataclass(frozen=True)
class SweepPlan:
    """One launch of a placement sweep over ``B * R`` flattened rows.

    A tile is 32 consecutive rows, one a lane of a warp: tile t holds rows
    ``tile_rows(t)``, the instance of row ``row`` is ``row // R``.  Warp w
    of block i takes tile ``i * warps + w`` (``warp_tiles(i, w)``: one
    tile, or none past the stack's end).  Staged path: a warp copies its
    tile's shares into its own ``buffer_doubles`` doubles of shared memory,
    at ``stride`` doubles a row by ``vec``-byte copies, beside the tables of
    the at most ``span`` instances the tile spans.  Direct path
    (``direct``; ``stride`` and ``buffer_doubles`` 0): each lane reads its
    row and its instance's tables from device memory.
    """

    B: int
    R: int
    n_t: int
    n_f: int
    warps: int
    stride: int
    span: int
    vec: int
    buffer_doubles: int
    grid: int
    direct: bool

    @property
    def n_rows(self) -> int:
        return self.B * self.R

    @property
    def tiles(self) -> int:
        return -(-self.n_rows // _TILE)

    @property
    def threads(self) -> int:
        return _TILE * self.warps

    @property
    def smem(self) -> int:
        return 8 * self.warps * self.buffer_doubles

    @property
    def path(self) -> str:
        return "direct" if self.direct else "staged"

    def warp_tiles(self, block: int, warp: int) -> range:
        return range(block * self.warps + warp, self.tiles, self.grid * self.warps)

    def tile_rows(self, t: int) -> range:
        return range(t * _TILE, min((t + 1) * _TILE, self.n_rows))

    def tile_instances(self, t: int) -> range:
        """The instances tile t spans (its staged tables, in order)."""
        rows = self.tile_rows(t)
        return range(rows[0] // self.R, rows[-1] // self.R + 1)

    def args(self) -> tuple[int, ...]:
        """The launchers' trailing size arguments."""
        return (self.grid, self.warps, self.stride, self.span, self.vec, self.buffer_doubles,
                int(self.direct), self.smem)


def _staged(B: int, R: int, n_t: int, n_f: int, stride: int) -> tuple[int, int]:
    """(instances a tile may span, doubles a warp stages on the staged
    path: the tile's rows at ``stride``, then the span's tables and two
    int32 counts an instance; even)."""
    span = min(B, -(-(_TILE - 1) // R) + 1)
    doubles = _TILE * stride + span * (n_t + 2 * n_f + 1)
    return span, doubles + doubles % 2


def staged_warps(plan: SweepPlan, sm_count: int) -> int:
    """Warps of ``plan``'s blocks (staged) the card holds at once."""
    return sm_count * _resident(plan.threads, plan.smem) * plan.warps


def sweep_plan(B: int, R: int, n_t: int, n_f: int, *, sm_count: int,
               aligned: bool = True) -> SweepPlan:
    """The launch for a ``(B, R, n_t)`` stack with ``n_f`` devices, on a
    card of ``sm_count`` SMs; ``aligned`` says the shares start 16-byte
    aligned (kernel 1 is ``B = 1``, ``R`` its rows).

    * Tiles of 32 rows, one tile a warp; blocks of up to 8 warps,
      fewer where 8 would leave SMs idle, so a small launch spreads one
      warp an SM.
    * Staged where the card holds every warp of the launch at once (a launch
      of latency: one round trip brings a warp's whole tile); direct where
      it does not (a launch bound by instruction throughput, where staging
      the rows only adds instructions), and where a tile does not fit
      ``MAX_SMEM``.
    * Copies: 16 bytes where ``aligned`` and n_t is even (row stride n_t
      or n_t + 2, even, so each 16-byte copy lands aligned), else 8 bytes
      (stride odd: a warp's reads at one task index are free of bank
      conflicts).
    """
    if min(B, R, n_t, n_f, sm_count) < 1:
        raise ValueError(f"a plan needs B, R, n_t, n_f, sm_count >= 1; got "
                         f"{B}, {R}, {n_t}, {n_f}, {sm_count}")
    tiles = -(-(B * R) // _TILE)
    vec = 16 if aligned and n_t % 2 == 0 else 8
    stride = (n_t if n_t % 4 == 2 else n_t + 2) if vec == 16 else n_t | 1
    span, doubles = _staged(B, R, n_t, n_f, stride)
    warps = min(_MAX_WARPS, -(-tiles // sm_count), max(1, _build.MAX_SMEM // (8 * doubles)))
    if -(-tiles // _MAX_WARPS) > _MAX_GRID:
        raise ValueError(f"{B * R} rows need more than {_MAX_GRID} blocks")
    plan = SweepPlan(B=B, R=R, n_t=n_t, n_f=n_f, warps=warps, stride=stride, span=span, vec=vec,
                     buffer_doubles=doubles, grid=-(-tiles // warps), direct=False)
    if 8 * doubles <= _build.MAX_SMEM and tiles <= staged_warps(plan, sm_count):
        return plan
    warps = min(_MAX_WARPS, -(-tiles // sm_count))
    return dataclasses.replace(plan, warps=warps, stride=0, buffer_doubles=0, direct=True,
                               grid=-(-tiles // warps))


_SM_COUNTS: dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _SM_COUNTS:
        _SM_COUNTS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNTS[index]



def _check_tensors(ref: torch.Tensor, dtype: torch.dtype, **named) -> None:
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} (the exact contract), got {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, shares on {ref.device}")


def _check(shares, iis, t_slr, t_cfg) -> tuple[int, int, int]:
    _check_tensors(shares, torch.float64, shares=shares, iis=iis, t_slr=t_slr, t_cfg=t_cfg)
    if shares.ndim != 2:
        raise ValueError(f"shares must be (B, n_t), got {tuple(shares.shape)}")
    B, n_t = shares.shape
    n_f = t_slr.shape[0] if t_slr.ndim == 1 else -1
    if iis.shape != (n_t,) or t_slr.ndim != 1 or t_cfg.shape != t_slr.shape:
        raise ValueError(
            f"tables must be iis ({n_t},), t_slr/t_cfg (n_f,); got "
            f"{tuple(iis.shape)}, {tuple(t_slr.shape)}, {tuple(t_cfg.shape)}"
        )
    if n_t == 0 or n_f == 0:
        raise ValueError("n_t == 0 / n_f == 0 blocks are answered by prepare_block")
    return B, n_t, n_f


def _check_batch(shares, iis, t_slr, t_cfg, n_t_eff, n_f_eff) -> tuple[int, int, int, int]:
    _check_tensors(shares, torch.float64, shares=shares, iis=iis, t_slr=t_slr, t_cfg=t_cfg)
    _check_tensors(shares, torch.int32, n_t_eff=n_t_eff, n_f_eff=n_f_eff)
    if shares.ndim != 3:
        raise ValueError(f"shares must be (B, R, n_t), got {tuple(shares.shape)}")
    B, R, n_t = shares.shape
    n_f = t_slr.shape[1] if t_slr.ndim == 2 else -1
    if (
        iis.shape != (B, n_t) or t_slr.ndim != 2 or t_slr.shape[0] != B
        or t_cfg.shape != t_slr.shape or n_t_eff.shape != (B,) or n_f_eff.shape != (B,)
    ):
        raise ValueError(
            f"tables must be iis ({B}, {n_t}), t_slr/t_cfg ({B}, n_f), counts ({B},); got "
            f"{tuple(iis.shape)}, {tuple(t_slr.shape)}, {tuple(t_cfg.shape)}, "
            f"{tuple(n_t_eff.shape)}, {tuple(n_f_eff.shape)}"
        )
    if n_t == 0 or n_f == 0:
        raise ValueError("batches of padded width 0 are answered by prepare_block")
    return B, R, n_t, n_f


def _plain_sweep_batch(shares, iis, t_slr, t_cfg, n_t_eff, n_f_eff, resume_cost, repay_init):
    """The plain batched sweep, plus the number of row-steps it took (live
    rows summed over iterations: the work the kernel does on these inputs)."""
    B, R, n_t, n_f = _check_batch(shares, iis, t_slr, t_cfg, n_t_eff, n_f_eff)
    nte = n_t_eff.long()[:, None]  # (B, 1): broadcast over each instance's rows
    nfe = n_f_eff.long()[:, None]
    if bool(((nte < 0) | (nte > n_t) | (nfe < 0) | (nfe > n_f)).any()):
        raise ValueError(f"live counts must lie in [0, {n_t}] / [0, {n_f}]")
    dev = shares.device
    j = torch.zeros((B, R), dtype=torch.int64, device=dev)  # device cursor
    k = torch.zeros((B, R), dtype=torch.int64, device=dev)  # task cursor (paper's sti)
    c = t_slr[:, :1].expand(B, R).clone()  # remaining capacity
    tsd = torch.zeros((B, R), dtype=torch.float64, device=dev)  # carried share of task k
    dead = torch.zeros((B, R), dtype=torch.bool, device=dev)
    n_splits = torch.zeros((B, R), dtype=torch.int64, device=dev)
    devices_used = torch.zeros((B, R), dtype=torch.int64, device=dev)
    zero = torch.zeros_like(tsd)
    resume = torch.full_like(tsd, float(resume_cost))
    steps = 0
    for _ in range(n_t + n_f):  # every live step advances j or k
        live = ~dead & (k < nte)
        n_live = int(live.sum())
        if n_live == 0:
            break
        steps += n_live
        kk = k.clamp(max=n_t - 1)  # safe gather index once k == n_t
        jj = j.clamp(max=n_f - 1)  # safe gather index once j == n_f
        ii = iis.gather(1, kk)
        tcfg = t_cfg.gather(1, jj)
        carried = tsd > _PLACE_EPS
        extra = torch.where(carried, ii if repay_init else resume, zero)
        rem = shares.gather(2, kk[..., None])[..., 0] - tsd
        avail = (c - tcfg) - extra
        can_start = (c > tcfg + ii + _PLACE_EPS) & (avail > _PLACE_EPS) & live
        split = can_start & (rem - avail > _PLACE_EPS)
        fits = can_start & ~split

        # Any placement (split or full) occupies the current device.
        devices_used = torch.where(can_start, torch.maximum(devices_used, jj + 1), devices_used)
        # Split: run `avail` here, carry the remainder to the next device.
        tsd = torch.where(split, tsd + avail, tsd)
        n_splits = n_splits + (split & ~carried)
        # Fits: consume cfg + extra + remaining share, advance the task.
        c_after = avail - rem
        closure = fits & (c_after <= tcfg + ii + _PLACE_EPS)
        c = torch.where(fits, c_after, c)
        k = k + fits
        tsd = torch.where(fits, zero, tsd)
        # Device advance: no-start, split carry, or closure after a fit.
        # The instance's live counts end a row, not the padded widths.
        advance = (~can_start | split | closure) & live
        j = j + advance
        dead = dead | (advance & (j >= nfe) & (k < nte))
        refill = advance & (j < nfe)
        c = torch.where(refill, t_slr.gather(1, j.clamp(max=n_f - 1)), c)
    feasible = (k >= nte) & ~dead
    outs = (feasible, k.to(torch.int32), n_splits.to(torch.int32), devices_used.to(torch.int32))
    return outs, steps


def _plain_sweep(shares, iis, t_slr, t_cfg, resume_cost, repay_init):
    """The plain single-instance sweep and its row-steps: the batched one
    over a stack of one instance whose live counts are its full widths."""
    B, n_t, n_f = _check(shares, iis, t_slr, t_cfg)
    counts = torch.tensor([[n_t], [n_f]], dtype=torch.int32, device=shares.device)
    outs, steps = _plain_sweep_batch(
        shares[None], iis[None], t_slr[None], t_cfg[None], counts[0], counts[1],
        resume_cost, repay_init,
    )
    return tuple(o[0] for o in outs), steps


def placement_sweep_plain(
    shares: torch.Tensor,
    iis: torch.Tensor,
    t_slr: torch.Tensor,
    t_cfg: torch.Tensor,
    *,
    resume_cost: float = 0.0,
    repay_init: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The placement sweep in plain torch ops, on the inputs' device.

    Mirrors ``ref.placement_sweep_ref`` / the numpy engine step for step:
    every live row either advances its task cursor (the current task
    fits) or its device cursor (no-start, split carry, or closure).
    """
    return _plain_sweep(shares, iis, t_slr, t_cfg, resume_cost, repay_init)[0]


def placement_sweep_batch_plain(
    shares: torch.Tensor,
    iis: torch.Tensor,
    t_slr: torch.Tensor,
    t_cfg: torch.Tensor,
    n_t_eff: torch.Tensor,
    n_f_eff: torch.Tensor,
    *,
    resume_cost: float = 0.0,
    repay_init: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fleet-parallel sweep in plain torch ops, on the inputs' device.

    Mirrors ``ref.placement_sweep_batch_ref``: instance ``b``'s rows run the
    single-instance sweep on its own tables, live while ``k < n_t_eff[b]``
    and dying when the device cursor reaches ``n_f_eff[b]`` with tasks left,
    so padded columns and slots never enter a live decision.  Padded rows
    (zero shares) are computed like any other; the caller masks them.
    """
    return _plain_sweep_batch(
        shares, iis, t_slr, t_cfg, n_t_eff, n_f_eff, resume_cost, repay_init
    )[0]


_P = ctypes.c_void_p
# The plan's fields (SweepPlan.args): grid, warps, stride, span, vec,
# buffer_doubles, direct, smem.
_PLAN_ARGTYPES = [ctypes.c_int] * 7 + [ctypes.c_longlong]
_SWEEP_ARGTYPES = [
    _P, _P, _P, _P, ctypes.c_double, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, *_PLAN_ARGTYPES,
]
_BATCH_ARGTYPES = [
    _P, _P, _P, _P, _P, _P, ctypes.c_double, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, *_PLAN_ARGTYPES,
]


def placement_sweep_cuda(
    shares: torch.Tensor,
    iis: torch.Tensor,
    t_slr: torch.Tensor,
    t_cfg: torch.Tensor,
    *,
    resume_cost: float = 0.0,
    repay_init: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA sweep on the current stream; does not synchronise.

    Every input must be a contiguous float64 CUDA tensor on one device.
    ``placement_sweep_cuda.launches`` counts the launches made (a ``B ==
    0`` block returns empty outputs and launches nothing).
    """
    B, n_t, n_f = _check(shares, iis, t_slr, t_cfg)
    _build.check_cuda(8 * (n_t + 2 * n_f), shares=shares, iis=iis, t_slr=t_slr, t_cfg=t_cfg)
    dev = shares.device
    feasible = torch.empty(B, dtype=torch.bool, device=dev)
    placed = torch.empty(B, dtype=torch.int32, device=dev)
    n_splits = torch.empty(B, dtype=torch.int32, device=dev)
    devices_used = torch.empty(B, dtype=torch.int32, device=dev)
    outs = (feasible, placed, n_splits, devices_used)
    if B == 0:
        return outs  # a grid of zero blocks is a launch error
    plan = sweep_plan(1, B, n_t, n_f, sm_count=_sm_count(dev),
                      aligned=shares.data_ptr() % 16 == 0)
    _build.launch("placement_sweep", "placement_sweep_f64", _SWEEP_ARGTYPES, (
        shares.data_ptr(), iis.data_ptr(), t_slr.data_ptr(), t_cfg.data_ptr(),
        float(resume_cost), int(bool(repay_init)), B, n_t, n_f,
        *(o.data_ptr() for o in outs), *plan.args(),
    ), dev)
    placement_sweep_cuda.launches += 1
    return outs


placement_sweep_cuda.launches = 0
placement_sweep_cuda.counters = {"placement_sweep": ("launches", ("placement_sweep_kernel",))}


def placement_sweep_batch_cuda(
    shares: torch.Tensor,
    iis: torch.Tensor,
    t_slr: torch.Tensor,
    t_cfg: torch.Tensor,
    n_t_eff: torch.Tensor,
    n_f_eff: torch.Tensor,
    *,
    resume_cost: float = 0.0,
    repay_init: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the fleet-parallel CUDA sweep on the current stream; does not
    synchronise.

    Tables are contiguous float64 and counts contiguous int32 CUDA tensors
    on one device.  The counts are not read back to be checked (that would
    synchronise): the kernel clamps them to the padded widths, so a count
    outside ``[0, n_t]`` / ``[0, n_f]`` cannot read past the tables.
    ``placement_sweep_batch_cuda.launches`` counts the launches made (an
    empty ``B * R == 0`` stack returns empty outputs and launches nothing).
    """
    B, R, n_t, n_f = _check_batch(shares, iis, t_slr, t_cfg, n_t_eff, n_f_eff)
    _build.check_cuda(
        8 * (n_t + 2 * n_f), shares=shares, iis=iis, t_slr=t_slr, t_cfg=t_cfg,
        n_t_eff=n_t_eff, n_f_eff=n_f_eff,
    )
    if B > _INT_MAX or R > _INT_MAX:
        raise ValueError(f"B = {B} and R = {R} must each fit a C int")
    dev = shares.device
    feasible = torch.empty((B, R), dtype=torch.bool, device=dev)
    placed = torch.empty((B, R), dtype=torch.int32, device=dev)
    n_splits = torch.empty((B, R), dtype=torch.int32, device=dev)
    devices_used = torch.empty((B, R), dtype=torch.int32, device=dev)
    outs = (feasible, placed, n_splits, devices_used)
    if B == 0 or R == 0:
        return outs  # a grid of zero blocks is a launch error
    plan = sweep_plan(B, R, n_t, n_f, sm_count=_sm_count(dev),
                      aligned=shares.data_ptr() % 16 == 0)
    _build.launch("placement_sweep_batch", "placement_sweep_batch_f64", _BATCH_ARGTYPES, (
        shares.data_ptr(), iis.data_ptr(), t_slr.data_ptr(), t_cfg.data_ptr(),
        n_t_eff.data_ptr(), n_f_eff.data_ptr(), float(resume_cost),
        int(bool(repay_init)), B, R, n_t, n_f, *(o.data_ptr() for o in outs), *plan.args(),
    ), dev)
    placement_sweep_batch_cuda.launches += 1
    return outs


placement_sweep_batch_cuda.launches = 0
placement_sweep_batch_cuda.counters = {
    "placement_sweep_batch": ("launches", ("placement_sweep_batch_kernel",))}
