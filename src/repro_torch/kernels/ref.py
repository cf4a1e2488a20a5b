"""Plain torch oracles of the ML kernels, twins of the JAX package's
``kernels/ref.py``.

* ``attention_ref``   — exact masked-softmax attention (GQA, causal,
  window, ``q_offset``, ``kv_len``), float32 inside.
* ``ssd_ref``         — Mamba-2 SSD in the naive O(S^2) materialised form.
* ``ssd_chunked_ref`` — SSD in the chunked dual form (intra-chunk
  quadratic products, inter-chunk state recurrence).
* ``ssd_decode_step`` — the single-token SSD recurrence of decode.
* ``rglru_ref``       — the RG-LRU recurrence (Griffin) over a sequence.
* ``rglru_decode_step`` — its single-token step.

They run on the inputs' device.  ``attention_ref`` is the plain version
of the flash-attention kernel, ``ssd_chunked_ref`` that of the SSD scan
kernel and ``rglru_ref`` that of the RG-LRU scan kernel
(``flash_attention.py``, ``ssd_scan.py``, ``rglru_scan.py``).
"""

from __future__ import annotations

import math

import torch

from ..sharding.ctx import cumsum, einsum, reshape

__all__ = [
    "attention_ref", "ssd_ref", "ssd_chunked_ref", "ssd_decode_step", "rglru_ref",
    "rglru_decode_step",
]

_NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_offset: int | torch.Tensor = 0,
    kv_len: int | torch.Tensor | None = None,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Exact attention oracle.  q: (B,S,H,hd), k/v: (B,T,K,hd); scores
    scaled by ``scale`` (1 / sqrt(hd) if None)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    g = H // K
    qf = reshape(q.float(), B, S, K, g, hd)
    qf = qf / math.sqrt(hd) if scale is None else qf * scale
    s = einsum("bskgd,btkd->bkgst", qf, k.float())
    qpos = q_offset + torch.arange(S, device=q.device)
    kpos = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask = mask & (kpos[None, :] < kv_len)
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if window > 0:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = einsum("bkgst,btkd->bskgd", p, v.float())
    return reshape(out, B, S, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality, arXiv:2405.21060)
# ---------------------------------------------------------------------------


def ssd_ref(
    x: torch.Tensor,  # (B, S, nh, hp)
    dt: torch.Tensor,  # (B, S, nh)       — softplus already applied
    A: torch.Tensor,  # (nh,)             — negative decay rates
    Bm: torch.Tensor,  # (B, S, ng, ds)
    Cm: torch.Tensor,  # (B, S, ng, ds)
    D: torch.Tensor,  # (nh,)             — skip connection
) -> torch.Tensor:
    """Naive SSD: y_t = sum_{s<=t} C_t^T (prod_{r=s+1..t} a_r) B_s x_s dt_s.

    Materialises the (S, S) semiseparable matrix per head — O(S^2) memory;
    oracle only.  Heads are grouped onto B/C groups: ng divides nh.
    """
    S, nh = x.shape[1], x.shape[2]
    rep = nh // Bm.shape[2]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf = Bm.float().repeat_interleave(rep, dim=2)  # (B,S,nh,ds)
    Cf = Cm.float().repeat_interleave(rep, dim=2)
    cum = torch.cumsum(dtf * Af[None, None, :], dim=1)  # (B,S,nh)
    diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B, t, s, nh)
    tri = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    Lmat = torch.where(tri[None, :, :, None], torch.exp(diff), 0.0)
    G = einsum("bthd,bshd->btsh", Cf, Bf)
    y = einsum("btsh,bshp,bsh->bthp", G * Lmat, xf, dtf)
    y = y + xf * D.float()[None, None, :, None]
    return y.to(x.dtype)


def ssd_chunked_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int = 64,
    initial_state: torch.Tensor | None = None,
    return_state: bool = False,
):
    """Chunked dual form: O(S * chunk) memory.

    Within a chunk the quadratic form of ``ssd_ref`` applies; across chunks
    a (nh, ds, hp) float32 state is carried:

        state_{c+1} = decay_chunk * state_c + B_c^T (x_c dt_c decay_in)
        y_c         = intra(x_c) + C_c (decay_out * state_c)
    """
    Bb, S, nh, hp = x.shape
    ng, ds = Bm.shape[2], Bm.shape[3]
    rep = nh // ng
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"S = {S} is not a multiple of chunk = {chunk}")

    xf = reshape(x.float(), Bb, nc, chunk, nh, hp)
    dtf = reshape(dt.float(), Bb, nc, chunk, nh)
    Af = A.float()
    Bf = reshape(Bm.float().repeat_interleave(rep, dim=2), Bb, nc, chunk, nh, ds)
    Cf = reshape(Cm.float().repeat_interleave(rep, dim=2), Bb, nc, chunk, nh, ds)

    cum = cumsum(dtf * Af[None, None, None, :], dim=2)  # within-chunk cumulative
    total = cum[:, :, -1, :]  # (B,nc,nh) — full-chunk log decay

    # --- intra-chunk (quadratic, per chunk) ---
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,t,s,nh)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    Lmat = torch.where(tri[None, None, :, :, None], torch.exp(diff), 0.0)
    G = einsum("bcthd,bcshd->bctsh", Cf, Bf)
    y_intra = einsum("bctsh,bcshp,bcsh->bcthp", G * Lmat, xf, dtf)

    # --- chunk states: decay from position s to the end of its chunk ---
    dec_in = torch.exp(total[:, :, None, :] - cum)  # (B,nc,C,nh)
    states = einsum("bcshd,bcsh,bcshp->bchdp", Bf, dtf * dec_in, xf)

    # --- inter-chunk recurrence over chunks ---
    dec_chunk = torch.exp(total)  # (B,nc,nh)
    carry = (
        torch.zeros((Bb, nh, ds, hp), dtype=torch.float32, device=x.device)  # repro-lint: ignore[P203]  # the SSD state is float32 by design (ML kernel, not the placement chain)
        if initial_state is None
        else initial_state.float()
    )
    state_in = []
    for c in range(nc):
        state_in.append(carry)  # the state entering chunk c
        carry = carry * dec_chunk[:, c, :, None, None] + states[:, c]
    state_in = torch.stack(state_in, dim=1)  # (B,nc,nh,ds,hp)

    # --- inter-chunk output: y += C_t * decay(0..t) * state_in ---
    dec_out = torch.exp(cum)  # (B,nc,C,nh)
    y_inter = einsum("bcthd,bcth,bchdp->bcthp", Cf, dec_out, state_in)

    y = reshape(y_intra + y_inter, Bb, S, nh, hp)
    y = y + x.float() * D.float()[None, None, :, None]
    y = y.to(x.dtype)
    if return_state:
        return y, carry
    return y


def ssd_decode_step(
    state: torch.Tensor,  # (B, nh, ds, hp) f32
    x: torch.Tensor,  # (B, nh, hp)
    dt: torch.Tensor,  # (B, nh)
    A: torch.Tensor,  # (nh,)
    Bm: torch.Tensor,  # (B, ng, ds)
    Cm: torch.Tensor,  # (B, ng, ds)
    D: torch.Tensor,  # (nh,)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD recurrence (O(1) decode).  Returns (y, new_state)."""
    rep = x.shape[1] // Bm.shape[1]
    xf, dtf = x.float(), dt.float()
    Bf = Bm.float().repeat_interleave(rep, dim=1)  # (B,nh,ds)
    Cf = Cm.float().repeat_interleave(rep, dim=1)
    a = torch.exp(dtf * A.float()[None, :])  # (B,nh)
    upd = einsum("bhd,bhp->bhdp", Bf, xf * dtf[..., None])
    new_state = state * a[:, :, None, None] + upd
    y = einsum("bhd,bhdp->bhp", Cf, new_state)
    y = y + xf * D.float()[None, :, None]
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma, arXiv:2402.19427)
# ---------------------------------------------------------------------------


def _rglru_gates(x, r_gate, i_gate, log_lambda, c: float):
    """(a, gated) in float32: a = exp(-c softplus(lam) sigmoid(r)) and
    gated = sqrt(max(1 - a^2, 1e-12)) sigmoid(i) x."""
    xf = x.float()
    rf = torch.sigmoid(r_gate.float())
    i_f = torch.sigmoid(i_gate.float())
    lf = log_lambda.float()
    lam = torch.clamp(lf, min=0.0) + torch.log1p(torch.exp(-lf.abs()))  # softplus, as logaddexp(x, 0)
    a = torch.exp(-c * lam * rf)
    return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i_f * xf)


def rglru_ref(
    x: torch.Tensor,  # (B, S, W)
    r_gate: torch.Tensor,  # (B, S, W) — recurrence gate pre-sigmoid
    i_gate: torch.Tensor,  # (B, S, W) — input gate pre-sigmoid
    log_lambda: torch.Tensor,  # (W,)  — learnable decay logits
    *,
    c: float = 8.0,
    initial_state: torch.Tensor | None = None,
    return_state: bool = False,
):
    """RG-LRU:  a_t = exp(-c * softplus(lam) * sigmoid(r_t)),
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (sigmoid(i_t) * x_t), h_{-1} = 0
    (or ``initial_state``), float32 inside.

    A doubling (Hillis-Steele) scan over time: log2(S) rounds, each
    combining every step with the one ``d`` before it, so the work is whole
    tensors rather than S dependent steps.  Returns h in x's type and, with
    ``return_state``, h[:, -1] rounded to x's type, as float32.
    """
    a, b = _rglru_gates(x, r_gate, i_gate, log_lambda[None, None, :], c)
    if initial_state is not None:
        b[:, 0] = b[:, 0] + a[:, 0] * initial_state.float()
    S = x.shape[1]
    d = 1
    while d < S:
        # (a1, b1) then (a2, b2) -> (a1 a2, b1 a2 + b2): step t takes t - d
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    h = b.to(x.dtype)
    if return_state:
        return h, h[:, -1].float()
    return h


def rglru_decode_step(
    state: torch.Tensor,  # (B, W) f32
    x: torch.Tensor,  # (B, W)
    r_gate: torch.Tensor,
    i_gate: torch.Tensor,
    log_lambda: torch.Tensor,
    *,
    c: float = 8.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One RG-LRU step.  Returns (h in x's type, h in float32)."""
    a, gated = _rglru_gates(x, r_gate, i_gate, log_lambda[None, :], c)
    h = a * state + gated
    return h.to(x.dtype), h
