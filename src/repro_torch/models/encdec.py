"""Encoder-decoder backbone (seamless-m4t-large-v2's text/audio backbone).

The audio frontend is a stub, as in the JAX package: the batch carries
precomputed frame embeddings ``enc_embeds`` (B, S_enc, D) straight into
the encoder.  Decoder layers add cross-attention over the encoder output;
decode keeps a growing self-attention KV cache and the fixed cross K/V
computed at the prefill.

Full-sequence attention goes through ``transformer._attn_dispatch`` on
``ExecConfig.attn_impl``'s route (``kernels.ops.flash_attention`` on
``"pallas"``, ``layers.chunked_attention`` on ``"xla"``): the encoder's
self-attention and the decoder's cross-attention without a mask, the
decoder's self-attention causally.  Decode (one query) runs
``layers.chunked_attention``.
"""

from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig
from ..sharding.ctx import einsum, embed_lookup, shard, write_slice
from .layers import rms_norm, swiglu
from .params import ParamSpec
from .transformer import (
    ExecConfig,
    _attn_dispatch,
    _cached_attention,
    _layer,
    _rotary,
    attn_specs,
    mlp_specs,
)

__all__ = [
    "encdec_specs",
    "encdec_forward",
    "encode",
    "encdec_decode_step",
    "init_encdec_cache",
]


def enc_block_specs(cfg: ModelConfig, L: int) -> dict[str, Any]:
    return {
        "ln1": ParamSpec((L, cfg.d_model), ("layers", "embed"), init="zeros"),
        "attn": attn_specs(cfg, L),
        "ln2": ParamSpec((L, cfg.d_model), ("layers", "embed"), init="zeros"),
        "mlp": mlp_specs(cfg, L),
    }


def dec_block_specs(cfg: ModelConfig, L: int) -> dict[str, Any]:
    s = enc_block_specs(cfg, L)
    s["ln_x"] = ParamSpec((L, cfg.d_model), ("layers", "embed"), init="zeros")
    s["xattn"] = attn_specs(cfg, L)
    return s


def encdec_specs(cfg: ModelConfig) -> dict[str, Any]:
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), init="embed"),
        "enc_blocks": enc_block_specs(cfg, cfg.enc_layers),
        "enc_ln": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        "dec_blocks": dec_block_specs(cfg, cfg.n_layers),
        "final_ln": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }


def _proj(hn: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return einsum("bsd,dhk->bshk", hn, w.to(hn.dtype))


def _proj_qkv(cfg: ModelConfig, ex: ExecConfig, a: dict, hn: torch.Tensor, pos: torch.Tensor):
    q, k, v = _proj(hn, a["wq"]), _proj(hn, a["wk"]), _proj(hn, a["wv"])
    if cfg.rope == "rope":
        q, k = _rotary(ex, q, k, pos, cfg.rope_theta)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv", None)
    v = shard(v, "batch", "seq", "kv", None)
    return q, k, v


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    return einsum("bshk,hkd->bsd", o, wo.to(o.dtype))


def _positions(h: torch.Tensor, start: int | torch.Tensor = 0) -> torch.Tensor:
    """Positions start..start+S-1 a row; ``start`` an int or a 0-d integer
    tensor on ``h``'s device (read there alone)."""
    B, S = h.shape[0], h.shape[1]
    return (start + torch.arange(S, device=h.device))[None, :].expand(B, S)


def encode(cfg: ModelConfig, ex: ExecConfig, params: dict, enc_embeds: torch.Tensor):
    """Bidirectional encoder over precomputed frame embeddings."""
    h = enc_embeds.to(getattr(torch, cfg.dtype))
    pos = _positions(h)

    def body(h, p):
        h = shard(h, "batch", "act_seq", None)
        hn = rms_norm(h, p["ln1"], cfg.norm_eps)
        q, k, v = _proj_qkv(cfg, ex, p["attn"], hn, pos)
        h = h + _out(_attn_dispatch(ex, q, k, v, causal=False, window=0), p["attn"]["wo"])
        h = shard(h, "batch", "act_seq", None)
        hn2 = rms_norm(h, p["ln2"], cfg.norm_eps)
        h = h + swiglu(hn2, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"])
        return shard(h, "batch", "act_seq", None)

    body = ex.remat_wrap(body)
    for i in range(cfg.enc_layers):
        h = body(h, _layer(params["enc_blocks"], i))
    return rms_norm(h, params["enc_ln"], cfg.norm_eps)


def _dec_block(cfg, ex, p, h, enc_out, pos, *, self_cache, cache_idx):
    """One decoder layer.  ``enc_out`` is the encoder output (prefill) or
    this layer's precomputed cross ``(k, v)`` (decode).  With ``self_cache``
    (one layer's ``(B, T, K, hd)`` pair) the step's k and v are written into
    it in place at ``cache_idx``.  Returns (h, self (k, v), cross (k, v))."""
    h = shard(h, "batch", "act_seq", None)
    # --- causal self-attention ---
    hn = rms_norm(h, p["ln1"], cfg.norm_eps)
    q, k, v = _proj_qkv(cfg, ex, p["attn"], hn, pos)
    if self_cache is None:
        out = _attn_dispatch(ex, q, k, v, causal=True, window=0)
        new_self = (k, v)
    else:
        ck, cv = self_cache
        write_slice(ck, k.to(ck.dtype), cache_idx)
        write_slice(cv, v.to(cv.dtype), cache_idx)
        out = _cached_attention(ex, q, ck, cv, cache_idx)
        new_self = (ck, cv)
    h = h + _out(out, p["attn"]["wo"])

    # --- cross-attention ---
    hn = rms_norm(h, p["ln_x"], cfg.norm_eps)
    xa = p["xattn"]
    qx = _proj(hn, xa["wq"])
    if isinstance(enc_out, tuple):  # precomputed cross K/V (decode)
        kx, vx = (t.to(h.dtype) for t in enc_out)
    else:
        kx, vx = _proj(enc_out, xa["wk"]), _proj(enc_out, xa["wv"])
    h = h + _out(_attn_dispatch(ex, qx, kx, vx, causal=False, window=0), xa["wo"])

    # --- MLP ---
    hn2 = rms_norm(h, p["ln2"], cfg.norm_eps)
    h = h + swiglu(hn2, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"])
    return shard(h, "batch", "act_seq", None), new_self, (kx, vx)


def _head(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return einsum("bsd,dv->bsv", h, params["lm_head"].to(h.dtype))


def encdec_forward(
    cfg: ModelConfig,
    ex: ExecConfig,
    params: dict,
    batch: dict,
    *,
    return_cache: bool = False,
):
    """Teacher-forced forward.  batch: enc_embeds (B, S_enc, D), tokens
    (B, S_dec).  Returns (logits, aux_loss) or (logits, aux_loss, cache);
    the cache is ``{"self": (k, v), "cross": (k, v)}``, each stacked over
    the decoder layers, ``(L, B, S_dec, K, hd)`` and ``(L, B, S_enc, K, hd)``."""
    enc_out = encode(cfg, ex, params, batch["enc_embeds"])
    h = embed_lookup(params["embed"], batch["tokens"]).to(getattr(torch, cfg.dtype))
    pos = _positions(h)
    kept: list[tuple] = []
    block = ex.remat_wrap(_dec_block)
    for i in range(cfg.n_layers):
        h, new_self, new_cross = block(cfg, ex, _layer(params["dec_blocks"], i), h, enc_out,
                                       pos, self_cache=None, cache_idx=None)
        if return_cache:
            kept.append((*new_self, *new_cross))
    logits = _head(cfg, params, h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if return_cache:
        sk, sv, xk, xv = (torch.stack(t) for t in zip(*kept, strict=True))
        return logits, aux, {"self": (sk, sv), "cross": (xk, xv)}
    return logits, aux


def init_encdec_cache(cfg: ModelConfig, batch_size: int, max_len: int, enc_len: int, dtype=None,
                      device=None):
    """Zero self-attention cache of ``max_len`` and cross cache of
    ``enc_len`` positions, each ``(L, B, T, K, hd)`` x2."""
    dt = dtype or getattr(torch, cfg.dtype)
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim

    def zeros(T):
        return torch.zeros((L, batch_size, T, K, hd), dtype=dt, device=device)

    return {"self": (zeros(max_len), zeros(max_len)), "cross": (zeros(enc_len), zeros(enc_len))}


def encdec_decode_step(cfg: ModelConfig, ex: ExecConfig, params: dict, cache, tokens,
                       idx: int | torch.Tensor):
    """One decoder token with cached self and cross attention: the token's
    self K/V is written at ``idx`` (an int, or a 0-d integer tensor on the
    cache's device) of every layer's cache, in place.  Returns (logits,
    cache)."""
    h = embed_lookup(params["embed"], tokens[:, None]).to(getattr(torch, cfg.dtype))
    pos = _positions(h, idx)
    (sk, sv), (xk, xv) = cache["self"], cache["cross"]
    for i in range(cfg.n_layers):
        h, _, _ = _dec_block(cfg, ex, _layer(params["dec_blocks"], i), h, (xk[i], xv[i]), pos,
                             self_cache=(sk[i], sv[i]), cache_idx=idx)
    return _head(cfg, params, h)[:, 0], cache
