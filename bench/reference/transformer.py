"""Plain float32 reference of the decoder-only transformer, dense and VLM.

The layer equations as the program defines its ``dense`` and ``vlm``
families (its departures from the published models included; see each
configuration's ``departures``): token embeddings behind an optional prefix
of patch embeddings; per layer, x + attn(rms(x)) then x + mlp(rms(x)) with
RMSNorm scaled by (1 + scale); grouped-query attention with a causal mask,
scores scaled by 1 / sqrt(hd); half-split rotary embeddings, and for the VLM
Qwen2-VL's M-RoPE, whose frequency slots are split into sections rotated
by the t, h and w position streams; a SwiGLU MLP; a final RMSNorm and the
head (the embedding, transposed, where it is tied).

Everything runs in float32 on the weights' device with TF32 off, one layer
at a time: a layer's bf16 weights are widened when it runs, so a model
whose weights fill the card still fits. Nothing of the program is
imported. ``quant`` (the control) rounds both operands of every product
but the router's to a lower precision before it runs.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_float32():
    """float32 products in float32: TF32 off for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def product(eq: str, x: torch.Tensor, w: torch.Tensor, quant=None) -> torch.Tensor:
    """``einsum(eq, x, w)`` in float32; under ``quant`` both operands are
    first rounded (x a row at a time, w as one tensor)."""
    w = w.float()
    if quant is not None:
        x, w = quant(x, rows=True), quant(w, rows=False)
    return torch.einsum(eq, x, w)


def rope_tables(positions: torch.Tensor, hd: int, theta: float, sections) -> tuple:
    """cos and sin (R, N, 1, hd / 2) of the rotation at ``positions``: (R, N)
    ids, or (R, N, 3) (t, h, w) ids whose ``sections`` of the frequency
    slots each follow one stream."""
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64, device=positions.device) / half)
    pos = positions.to(torch.float64)
    if sections:
        parts, start = [], 0
        for j, n in enumerate(sections):
            parts.append(pos[..., j : j + 1] * inv[start : start + n])
            start += n
        ang = torch.cat(parts, dim=-1)
    else:
        ang = pos[..., None] * inv
    return torch.cos(ang).float()[:, :, None], torch.sin(ang).float()[:, :, None]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Causal softmax attention, q (R, N, H, hd) against k, v (R, N, K, hd),
    query head h reading kv head h // (H / K); ``block`` queries at a time."""
    R, N, H, hd = q.shape
    g = H // k.shape[2]
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)  # (R, H, N, hd)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    q = q.transpose(1, 2) / math.sqrt(hd)
    out = torch.empty_like(q)
    keys = torch.arange(N, device=q.device)
    for s in range(0, N, block):
        e = min(N, s + block)
        scores = q[:, :, s:e] @ k[:, :, :e].transpose(-1, -2)  # (R, H, b, e)
        mask = keys[None, :e] <= torch.arange(s, e, device=q.device)[:, None]
        scores = scores.masked_fill(~mask, float("-inf"))
        out[:, :, s:e] = torch.softmax(scores, dim=-1) @ v[:, :, :e]
    return out.transpose(1, 2)


def mlp(hn: torch.Tensor, p: dict, quant=None) -> torch.Tensor:
    g = product("rnd,df->rnf", hn, p["w_gate"], quant)
    u = product("rnd,df->rnf", hn, p["w_up"], quant)
    return product("rnf,fd->rnd", F.silu(g) * u, p["w_down"], quant)


def layer(i: int, tree: dict) -> dict:
    """Layer i's slice of a stacked (L, ...) tree, as views."""
    return {k: layer(i, v) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def forward(a: dict, weights: dict, inputs: dict, *, out_start: int, ffn=None,
            quant=None) -> torch.Tensor:
    """float32 logits (R, N - out_start, V) at positions out_start.. of R
    sequences of N positions.

    ``inputs``: ``tokens`` (R, n_text) ids; ``patch_embeds`` (R, n_img, D),
    a prefix before the tokens (VLM); ``positions`` (R, N) or (R, N, 3)
    ids; ``prompt`` the prompt's positions (what a MoE routes as one
    group). ``ffn(hn, p, inputs, quant)`` is the feed-forward (the MLP if
    None)."""
    eps = a["norm_eps"]
    hd = a.get("head_dim") or a["d_model"] // a["n_heads"]
    h = weights["embed"][inputs["tokens"].long()].float()
    if inputs.get("patch_embeds") is not None:
        h = torch.cat([inputs["patch_embeds"].float(), h], dim=1)
    sections = a.get("mrope_sections") if a.get("rope") == "mrope" else None
    cos, sin = rope_tables(inputs["positions"], hd, a["rope_theta"], sections)
    blocks = weights["blocks"]
    for i in range(a["n_layers"]):
        p = layer(i, blocks)
        at = p["attn"]
        hn = rms_norm(h, p["ln1"], eps)
        q = product("rnd,dhk->rnhk", hn, at["wq"], quant)
        k = product("rnd,dhk->rnhk", hn, at["wk"], quant)
        v = product("rnd,dhk->rnhk", hn, at["wv"], quant)
        if "bq" in at:
            q, k, v = q + at["bq"].float(), k + at["bk"].float(), v + at["bv"].float()
        o = attention(rotate(q, cos, sin), rotate(k, cos, sin), v)
        h = h + product("rnhk,hkd->rnd", o, at["wo"], quant)
        hn = rms_norm(h, p["ln2"], eps)
        h = h + (ffn(hn, p, inputs, quant) if ffn is not None else mlp(hn, p["mlp"], quant))
    h = rms_norm(h[:, out_start:], weights["final_ln"], eps)
    head = weights["embed"].T if a.get("tie_embeddings") else weights["lm_head"]
    return product("rnd,dv->rnv", h, head, quant)


def logits(a: dict, weights: dict, inputs: dict, *, out_start: int, quant=None) -> torch.Tensor:
    """The dense or VLM model's logits (see ``forward``)."""
    with exact_float32(), torch.no_grad():
        return forward(a, weights, inputs, out_start=out_start, quant=quant)
