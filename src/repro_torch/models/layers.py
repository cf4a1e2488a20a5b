"""Shared neural layers: RMS norm, rotary embeddings, attention, SwiGLU.

Functions over tensors; parameters arrive as (sub)trees of the spec
functions in the sibling model files.  The cast points are the JAX
package's: norms, RoPE, the softmax and the SiLU in float32, the products
in the activations' type (``cfg.dtype``).

``chunked_attention`` is the online-softmax attention in plain torch ops,
used for decode (one query against a cache with a runtime fill) and by
``ops.flash_attention`` wherever the flash kernel does not apply.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "make_rope_freqs", "apply_rope", "chunked_attention", "swiglu"]

_NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    rms = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf / rms) * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def make_rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    # x: (..., hd); cos/sin: broadcastable (..., hd//2) — half-split rotation
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Standard RoPE.  x: (B, S, H, hd); positions: (B, S) int."""
    freqs = make_rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions.float()[..., None] * freqs  # (B, S, hd//2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    return _rotate(x, cos, sin)


# ---------------------------------------------------------------------------
# Attention — chunked online softmax (the flash-attention algorithm in torch ops)
# ---------------------------------------------------------------------------


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_offset: int | torch.Tensor = 0,
    kv_len: int | torch.Tensor | None = None,
    causal: bool = True,
    window: int = 0,
    kv_chunk: int = 1024,
    p_dtype: str = "float32",
) -> torch.Tensor:
    """GQA attention with bounded memory: O(S * kv_chunk) score tiles.

    q: (B, S, H, hd);  k, v: (B, T, K, hd) with H = K * group.
    ``q_offset``: absolute position of q[0] (prefill continuation /
    decode).  ``kv_len``: valid prefix length of k/v (decode caches);
    None means all T positions are valid.  ``window`` > 0 enables
    sliding-window (local) masking:  qpos - kpos < window.  The p @ v
    product takes p and v rounded to ``p_dtype`` and sums in float32.
    """
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    g = H // K
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    qf = (q.float() * scale).reshape(B, S, K, g, hd)
    nc = -(-T // kv_chunk)
    Tp = nc * kv_chunk
    if Tp != T:
        pad = (0, 0, 0, 0, 0, Tp - T)
        k, v = F.pad(k, pad), F.pad(v, pad)

    qpos = q_offset + torch.arange(S, device=dev)
    valid_len = T if kv_len is None else kv_len
    pdt = getattr(torch, p_dtype)

    m = torch.full((B, K, g, S), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, K, g, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, K, g, S, hd), dtype=torch.float32, device=dev)
    for c in range(nc):
        c0 = c * kv_chunk
        kci, vci = k[:, c0 : c0 + kv_chunk], v[:, c0 : c0 + kv_chunk]
        s = torch.einsum("bskgd,bckd->bkgsc", qf, kci.float())
        kpos = c0 + torch.arange(kv_chunk, device=dev)
        mask = kpos[None, :] < valid_len
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        if window > 0:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        s = torch.where(mask, s, _NEG_INF)
        mc = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - mc[..., None])
        corr = torch.exp(m - mc)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgsc,bckd->bkgsd", p.to(pdt).float(), vci.to(pdt).float())
        acc = acc * corr[..., None] + pv
        m = mc

    out = acc / torch.clamp(l[..., None], min=1e-30)  # (B, K, g, S, hd)
    out = out.permute(0, 3, 1, 2, 4)  # (B, S, K, g, hd)
    return out.reshape(B, S, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Feed-forward
# ---------------------------------------------------------------------------


def swiglu(
    x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor
) -> torch.Tensor:
    dt = x.dtype
    g = torch.einsum("bsd,df->bsf", x, w_gate.to(dt))
    u = torch.einsum("bsd,df->bsf", x, w_up.to(dt))
    h = F.silu(g.float()).to(dt) * u
    return torch.einsum("bsf,fd->bsd", h, w_down.to(dt))
