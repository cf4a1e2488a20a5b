"""Alg-2 TFS-block placement sweep: the CUDA kernel and its plain version.

The port of ``placement_sweep_pallas`` (the JAX package's
``kernels/placement_step.py``).  Both functions here take a ``(B, n_t)``
float64 shares block with the ``(n_t,)`` per-task initialization
intervals and the ``(n_f,)`` per-device capacity / reconfiguration tables,
and return ``(feasible, placed_tasks, n_splits, devices_used)`` as ``(B,)``
tensors (bool, int32, int32, int32) on the input's device:

* :func:`placement_sweep_plain` — the sweep in torch ops, one masked
  carry/split step over all rows per iteration; runs on any device.  The
  CPU tests and the ``"torch"`` engine use it.
* :func:`placement_sweep_cuda` — the hand-written kernel
  (``csrc/placement_sweep.cu``), one thread per row, CUDA tensors only.

Both replay the scalar oracle's float64 operations in the same order, so
their outputs are equal bit for bit.  Degenerate ``n_t == 0`` / ``n_f ==
0`` blocks are the caller's (``placement_backends.base.prepare_block``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["placement_sweep_plain", "placement_sweep_cuda"]

_PLACE_EPS = 1e-9  # == repro_torch.core.placement._EPS
_THREADS = 256  # == kThreads in csrc/placement_sweep.cu
_MAX_SMEM = 232_448  # bytes of shared memory one H100 block may use


def _check(shares, iis, t_slr, t_cfg) -> tuple[int, int, int]:
    for name, t in (("shares", shares), ("iis", iis), ("t_slr", t_slr), ("t_cfg", t_cfg)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64 (the exact contract), got {t.dtype}")
        if t.device != shares.device:
            raise ValueError(f"{name} is on {t.device}, shares on {shares.device}")
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


def _plain_sweep(shares, iis, t_slr, t_cfg, resume_cost, repay_init):
    """The plain sweep, plus the number of row-steps it took (live rows
    summed over iterations: the work the kernel does on these inputs)."""
    B, n_t, n_f = _check(shares, iis, t_slr, t_cfg)
    dev = shares.device
    j = torch.zeros(B, dtype=torch.int64, device=dev)  # device cursor
    k = torch.zeros(B, dtype=torch.int64, device=dev)  # task cursor (paper's sti)
    c = t_slr[0].expand(B).clone()  # remaining capacity
    tsd = torch.zeros(B, dtype=torch.float64, device=dev)  # carried share of task k
    dead = torch.zeros(B, dtype=torch.bool, device=dev)
    n_splits = torch.zeros(B, dtype=torch.int64, device=dev)
    devices_used = torch.zeros(B, dtype=torch.int64, device=dev)
    zero = torch.zeros_like(tsd)
    resume = torch.full_like(tsd, float(resume_cost))
    steps = 0
    for _ in range(n_t + n_f):  # every live step advances j or k
        live = ~dead & (k < n_t)
        n_live = int(live.sum())
        if n_live == 0:
            break
        steps += n_live
        kk = k.clamp(max=n_t - 1)  # safe gather index once k == n_t
        jj = j.clamp(max=n_f - 1)  # safe gather index once j == n_f
        ii = iis[kk]
        tcfg = t_cfg[jj]
        carried = tsd > _PLACE_EPS
        extra = torch.where(carried, ii if repay_init else resume, zero)
        rem = shares.gather(1, kk[:, None])[:, 0] - tsd
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
        advance = (~can_start | split | closure) & live
        j = j + advance
        dead = dead | (advance & (j >= n_f) & (k < n_t))
        refill = advance & (j < n_f)
        c = torch.where(refill, t_slr[j.clamp(max=n_f - 1)], c)
    feasible = (k >= n_t) & ~dead
    outs = (feasible, k.to(torch.int32), n_splits.to(torch.int32), devices_used.to(torch.int32))
    return outs, steps


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


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.placement_sweep_f64
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [
            p, p, p, p, ctypes.c_double, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, p, p, p, p, p,
        ]
        fn.restype = ctypes.c_int
        lib.placement_sweep_error_string.argtypes = [ctypes.c_int]
        lib.placement_sweep_error_string.restype = ctypes.c_char_p
    return lib


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
    if shares.device.type != "cuda":
        raise ValueError(f"placement_sweep_cuda needs CUDA tensors, got {shares.device}")
    for name, t in (("shares", shares), ("iis", iis), ("t_slr", t_slr), ("t_cfg", t_cfg)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    smem = 8 * (n_t + 2 * n_f)
    if smem > _MAX_SMEM:
        raise ValueError(f"tables need {smem} bytes of shared memory (> {_MAX_SMEM})")
    dev = shares.device
    feasible = torch.empty(B, dtype=torch.bool, device=dev)
    placed = torch.empty(B, dtype=torch.int32, device=dev)
    n_splits = torch.empty(B, dtype=torch.int32, device=dev)
    devices_used = torch.empty(B, dtype=torch.int32, device=dev)
    outs = (feasible, placed, n_splits, devices_used)
    if B == 0:
        return outs  # a grid of zero blocks is a launch error
    lib = _bind(_build.load_library("placement_sweep"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.placement_sweep_f64(
            shares.data_ptr(), iis.data_ptr(), t_slr.data_ptr(), t_cfg.data_ptr(),
            float(resume_cost), int(bool(repay_init)), B, n_t, n_f,
            feasible.data_ptr(), placed.data_ptr(), n_splits.data_ptr(),
            devices_used.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.placement_sweep_error_string(err).decode()
        raise RuntimeError(f"placement_sweep kernel launch failed: {msg} ({err})")
    placement_sweep_cuda.launches += 1
    return outs


placement_sweep_cuda.launches = 0
