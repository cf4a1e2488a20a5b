"""Public kernel entry points, dispatched on the tensors' device.

A CPU tensor goes to the kernel's plain torch version; a CUDA tensor goes
to the hand-written kernel.  There is no fallback between the two: a CUDA
tensor either runs through the kernel or raises, and any other device
raises.  The kernels have no backward: under grad mode a CUDA input that
requires grad raises, and training takes ``ExecConfig(attn_impl="xla")``,
which does not come here.
"""

from __future__ import annotations

import torch

from .decode_attention import decode_attention_cuda, decode_attention_plain
from .flash_attention import flash_attention_cuda, flash_attention_plain
from .mla_decode import mla_decode_cuda, mla_decode_plain
from .placement_step import (
    placement_sweep_batch_cuda,
    placement_sweep_batch_plain,
    placement_sweep_cuda,
    placement_sweep_plain,
)
from .rglru_scan import rglru_scan_cuda, rglru_scan_plain
from .rotary import rotary_cuda, rotary_plain
from .ssd_scan import ssd_scan_cuda, ssd_scan_plain

__all__ = ["flash_attention", "decode_attention", "mla_decode", "rotary", "ssd_scan",
           "rglru_scan", "placement_sweep", "placement_sweep_batch"]


def _pick(t: torch.Tensor, plain, kernel, name: str):
    kind = t.device.type
    if kind == "cpu":
        return plain
    if kind == "cuda":
        return kernel
    raise ValueError(f"{name} runs on cpu or cuda tensors, got {t.device}")


def placement_sweep(
    shares: torch.Tensor,
    iis: torch.Tensor,
    t_slr: torch.Tensor,
    t_cfg: torch.Tensor,
    *,
    resume_cost: float = 0.0,
    repay_init: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alg-2 TFS-block placement sweep; returns ``(feasible, placed_tasks,
    n_splits, devices_used)`` on the inputs' device.  On CUDA the launch is
    asynchronous: the outputs are ready once the current stream gets there.
    The scheduler-facing entry is ``repro_torch.core.placement_backends``."""
    fn = _pick(shares, placement_sweep_plain, placement_sweep_cuda, "placement_sweep")
    return fn(shares, iis, t_slr, t_cfg, resume_cost=resume_cost, repay_init=repay_init)


def placement_sweep_batch(
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
    """Fleet-parallel sweep over a ``(B, R, n_t)`` instance stack; returns
    ``(feasible, placed_tasks, n_splits, devices_used)`` as ``(B, R)`` on
    the inputs' device.  Ragged instances arrive padded: ``n_t_eff`` /
    ``n_f_eff`` (int32) carry each instance's live widths.  On CUDA the
    launch is asynchronous.  The scheduler-facing entry is
    ``PADPSFRScheduler.schedule_many``."""
    fn = _pick(shares, placement_sweep_batch_plain, placement_sweep_batch_cuda,
               "placement_sweep_batch")
    return fn(shares, iis, t_slr, t_cfg, n_t_eff, n_f_eff,
              resume_cost=resume_cost, repay_init=repay_init)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_offset: int = 0,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """GQA attention of q (B, S, H, hd), its first query at position
    ``q_offset``, against every key of k, v (B, T, K, hd) (train, prefill),
    scores scaled by ``scale`` (1 / sqrt(hd) if None).  A CUDA tensor runs
    the flash kernel (``flash_attention_cuda``), a CPU tensor
    ``flash_attention_plain``."""
    fn = _pick(q, flash_attention_plain, flash_attention_cuda, "flash_attention")
    q, k, v = (t.contiguous() for t in (q, k, v))  # the kernel reads dense rows
    return fn(q, k, v, causal=causal, window=window, q_offset=q_offset, scale=scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     q_offset: int | torch.Tensor = 0, kv_len: int | torch.Tensor | None = None,
                     causal: bool = True, window: int = 0, p_dtype: str = "float32",
                     scale: float | None = None) -> torch.Tensor:
    """Attention of one query position, q (B, 1, H, hd) at ``q_offset``,
    against a cache k, v (B, T, K, hd) filled to ``kv_len`` (None: all T),
    p @ v in ``p_dtype``.  A CUDA tensor runs kernel 6
    (``decode_attention_cuda``: the cache in its own type, a tensor
    ``q_offset`` and ``kv_len`` read on the device), a CPU tensor
    ``decode_attention_plain`` (``ref.chunked_attention`` over one chunk of
    T keys)."""
    fn = _pick(q, decode_attention_plain, decode_attention_cuda, "decode_attention")
    if fn is decode_attention_cuda:
        q, k, v = (t.contiguous() for t in (q, k, v))  # the kernel reads dense rows
    return fn(q, k, v, q_offset=q_offset, kv_len=kv_len, causal=causal, window=window,
              p_dtype=p_dtype, scale=scale)


def mla_decode(q: torch.Tensor, ckv: torch.Tensor, kr: torch.Tensor, *,
               kv_len: int | torch.Tensor, scale: float) -> torch.Tensor:
    """Latent attention's absorbed decode: q (B, H, r + rope) against the
    latent cache ckv (B, T, r), also the value, and the rope keys kr
    (B, T, rope); returns (B, H, r).  A CUDA tensor runs kernel 7
    (``mla_decode_cuda``, ``kv_len`` a tensor read on the device), a CPU
    tensor ``mla_decode_plain``."""
    fn = _pick(q, mla_decode_plain, mla_decode_cuda, "mla_decode")
    return fn(q, ckv, kr, kv_len=kv_len, scale=scale)


def rotary(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, theta: float,
           sections: tuple[int, ...] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, S, Hq, D) and k (B, S, Hk, D) rotated by their shared
    positions: RoPE with ``sections`` None and positions (B, S), M-RoPE
    with positions (B, S, len(sections)).  A CUDA tensor runs kernel 8
    (``rotary_cuda``: both in one launch, in place), a CPU tensor
    ``rotary_plain`` (``apply_rope`` / ``apply_mrope``, new tensors);
    either way the caller takes the returned pair."""
    fn = _pick(q, rotary_plain, rotary_cuda, "rotary")
    return fn(q, k, positions, theta, sections)


def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk: int = 128, return_state: bool = False):
    """Mamba-2 SSD chunked scan; ``chunk`` shrinks to the largest divisor of
    S not above it.  Returns y, or ``(y, final_state)``."""
    S = x.shape[1]
    while S % chunk:
        chunk -= 1
    fn = _pick(x, ssd_scan_plain, ssd_scan_cuda, "ssd_scan")
    x, dt, A, Bm, Cm, D = (t.contiguous() for t in (x, dt, A, Bm, Cm, D))
    return fn(x, dt, A, Bm, Cm, D, chunk=chunk, return_state=return_state)


def rglru_scan(x, r_gate, i_gate, log_lambda, *, c: float = 8.0, return_state: bool = False):
    """RG-LRU scan of x, r, i (B, S, W) with log_lambda (W,).  Returns y, or
    ``(y, final_state)`` with a float32 (B, W) state."""
    fn = _pick(x, rglru_scan_plain, rglru_scan_cuda, "rglru_scan")
    x, r_gate, i_gate, log_lambda = (t.contiguous() for t in (x, r_gate, i_gate, log_lambda))
    return fn(x, r_gate, i_gate, log_lambda, c=c, return_state=return_state)
