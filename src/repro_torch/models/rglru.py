"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local
(sliding-window) attention blocks in a repeating pattern (rec, rec, attn).

The parameter and state trees are the JAX package's: the pattern's
positions stacked over *super-blocks* under ``super`` (``(n_super, ...)``),
and the pattern's remainder, if any, under ``rest`` (``(1, ...)``).  A
Python loop over super-blocks takes the place of ``lax.scan``.

The full-sequence forward runs the RG-LRU scan and local attention on
``ExecConfig.attn_impl``'s route: ``"pallas"`` runs
``kernels.ops.rglru_scan`` and ``kernels.ops.flash_attention(window=...)``
(the kernels on CUDA tensors, their plain versions on CPU tensors),
``"xla"`` (training's) ``ref.rglru_ref`` and ``layers.chunked_attention``.
Decode is bounded: a recurrent layer carries its conv tail and a float32
(B, W) state and runs ``ref.rglru_decode_step``; an attention layer keeps
a ring-buffer KV cache of ``local_window`` slots and attends over it in
plain torch (the JAX package runs no kernel there either).  Decode updates the
state in place.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from ..kernels import ref as kref
from ..sharding.ctx import einsum, embed_lookup, reshape, shard, write_slice
from .layers import _NEG_INF, decode_positions, rms_norm, swiglu
from .params import ParamSpec
from .ssm import _causal_conv, _conv_step, _head
from .transformer import ExecConfig, _attn_dispatch, _layer, _rotary, attn_specs, mlp_specs

__all__ = ["hybrid_specs", "hybrid_forward", "hybrid_decode_step", "init_hybrid_state"]

_N_DIAG_BLOCKS = 8  # Griffin's block-diagonal gate projections
_CONV = 4  # temporal conv width


def _pattern_split(cfg: ModelConfig) -> tuple[int, tuple[str, ...]]:
    pat = cfg.block_pattern
    n_super = cfg.n_layers // len(pat)
    rest = cfg.layer_kinds()[n_super * len(pat) :]
    return n_super, rest


def rec_block_specs(cfg: ModelConfig, L: int) -> dict[str, Any]:
    D = cfg.d_model
    W = cfg.lru_width or D
    nb = _N_DIAG_BLOCKS
    wb = W // nb
    return {
        "ln1": ParamSpec((L, D), ("layers", "embed"), init="zeros"),
        "w_gate_br": ParamSpec((L, D, W), ("layers", "embed", "state")),
        "w_rec_br": ParamSpec((L, D, W), ("layers", "embed", "state")),
        "conv_w": ParamSpec((L, _CONV, W), ("layers", "conv", "state"), init="normal"),
        "conv_b": ParamSpec((L, W), ("layers", "state"), init="zeros"),
        # block-diagonal RG-LRU gate projections
        "wa": ParamSpec((L, nb, wb, wb), ("layers", None, "state", None)),
        "wx": ParamSpec((L, nb, wb, wb), ("layers", None, "state", None)),
        "ba": ParamSpec((L, W), ("layers", "state"), init="zeros"),
        "bx": ParamSpec((L, W), ("layers", "state"), init="zeros"),
        "log_lambda": ParamSpec((L, W), ("layers", "state"), init="recurrent"),
        "w_out": ParamSpec((L, W, D), ("layers", "state", "embed")),
        "ln2": ParamSpec((L, D), ("layers", "embed"), init="zeros"),
        "mlp": mlp_specs(cfg, L),
    }


def attn_block_specs(cfg: ModelConfig, L: int) -> dict[str, Any]:
    return {
        "ln1": ParamSpec((L, cfg.d_model), ("layers", "embed"), init="zeros"),
        "attn": attn_specs(cfg, L),
        "ln2": ParamSpec((L, cfg.d_model), ("layers", "embed"), init="zeros"),
        "mlp": mlp_specs(cfg, L),
    }


def _kind_specs(cfg: ModelConfig, kind: str, L: int) -> dict[str, Any]:
    return rec_block_specs(cfg, L) if kind == "rec" else attn_block_specs(cfg, L)


def hybrid_specs(cfg: ModelConfig) -> dict[str, Any]:
    n_super, rest = _pattern_split(cfg)
    s: dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), init="embed"),
        "final_ln": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        "super": {str(i): _kind_specs(cfg, k, n_super) for i, k in enumerate(cfg.block_pattern)},
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }
    if rest:
        s["rest"] = {str(i): _kind_specs(cfg, k, 1) for i, k in enumerate(rest)}
    return s


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _block_diag(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, W) @ block-diag w: (nb, wb, wb) + b.  On a mesh whose
    'state' axis the blocks do not fill, the product is a partial sum over
    it; it is reduced to the gates' placement before the bias is added
    (torch 2.11's DTensor cannot add a sharded bias to a partial sum)."""
    B, S, W = x.shape
    nb, wb = w.shape[0], w.shape[1]
    y = einsum("bsnw,nwv->bsnv", reshape(x, B, S, nb, wb), w.to(x.dtype))
    return shard(reshape(y, B, S, W), "batch", "seq", "state") + b.to(x.dtype)


def _rec_block(cfg: ModelConfig, ex: ExecConfig, p: dict, h, *, state, return_state):
    """Griffin recurrent block.  state: {'conv': (B, 3, W), 'h': (B, W)} or None."""
    dt = h.dtype
    h = shard(h, "batch", "act_seq", None)
    hn = rms_norm(h, p["ln1"], cfg.norm_eps)
    # jax.nn.gelu's default is the tanh approximation
    gate = F.gelu(einsum("bsd,dw->bsw", hn, p["w_gate_br"].to(dt)).float(),
                  approximate="tanh").to(dt)
    gate = shard(gate, "batch", "seq", "state")
    xr = shard(einsum("bsd,dw->bsw", hn, p["w_rec_br"].to(dt)), "batch", "seq", "state")

    new_state = {}
    if state is None:
        xc = _causal_conv(xr, p["conv_w"]) + p["conv_b"].to(dt)
        if return_state:
            new_state["conv"] = xr[:, -(p["conv_w"].shape[0] - 1) :].to(dt)
    else:
        xc1, new_state["conv"] = _conv_step(state["conv"], xr[:, 0], p["conv_w"])
        xc = (xc1 + p["conv_b"].to(dt))[:, None]

    r_gate = _block_diag(xc, p["wa"], p["ba"])
    i_gate = _block_diag(xc, p["wx"], p["bx"])

    if state is None:
        scan = ops.rglru_scan if ex.attn_impl == "pallas" else kref.rglru_ref
        out = scan(xc, r_gate, i_gate, p["log_lambda"], return_state=return_state)
        if return_state:
            y, new_state["h"] = out
        else:
            y = out
    else:
        y1, new_state["h"] = kref.rglru_decode_step(
            state["h"], xc[:, 0], r_gate[:, 0], i_gate[:, 0], p["log_lambda"]
        )
        y = y1[:, None]

    y = y * gate
    h = shard(h + einsum("bsw,wd->bsd", y, p["w_out"].to(dt)), "batch", "act_seq", None)
    hn2 = rms_norm(h, p["ln2"], cfg.norm_eps)
    m = p["mlp"]
    h = h + swiglu(hn2, m["w_gate"], m["w_up"], m["w_down"])
    return shard(h, "batch", "act_seq", None), (
        new_state if (state is not None or return_state) else None
    )


def _ring_positions(idx: int | torch.Tensor, window: int, device) -> torch.Tensor:
    """Absolute position held by each ring slot after writing position
    ``idx`` (an int, or a 0-d integer tensor on ``device``): slot s holds
    idx - ((idx - s) mod window); < 0 means never written."""
    s = torch.arange(window, device=device)
    return idx - torch.remainder(idx - s, window)


def _attn_block(cfg: ModelConfig, ex: ExecConfig, p: dict, h, *, state, idx, return_state):
    """Local-attention block with a ring-buffer KV cache for decode.  state:
    {'ck', 'cv': (B, window, K, hd)} or None; decode writes slot
    ``idx mod window`` of both in place."""
    dt = h.dtype
    win = cfg.local_window
    h = shard(h, "batch", "act_seq", None)
    hn = rms_norm(h, p["ln1"], cfg.norm_eps)
    a = p["attn"]
    q = shard(einsum("bsd,dhk->bshk", hn, a["wq"].to(dt)), "batch", "seq", "heads", None)
    k = shard(einsum("bsd,dhk->bshk", hn, a["wk"].to(dt)), "batch", "seq", "kv", None)
    v = shard(einsum("bsd,dhk->bshk", hn, a["wv"].to(dt)), "batch", "seq", "kv", None)

    new_state = {}
    B, S = hn.shape[0], hn.shape[1]
    if state is None:
        pos = torch.arange(S, device=h.device)[None, :].expand(B, S)
        q, k = _rotary(ex, q, k, pos, cfg.rope_theta)
        out = _attn_dispatch(ex, q, k, v, causal=True, window=win)
        if return_state:
            # the ring from the last `window` positions; slots a short
            # prompt never reached hold position 0's k, v and are masked
            safe = torch.clamp(_ring_positions(S - 1, win, h.device), 0, S - 1)
            new_state["ck"] = k[:, safe].to(dt)
            new_state["cv"] = v[:, safe].to(dt)
    else:
        pos = decode_positions(idx, (B, 1), h.device)
        q, k = _rotary(ex, q, k, pos, cfg.rope_theta)
        ck, cv = state["ck"], state["cv"]
        slot = idx % win
        write_slice(ck, k.to(ck.dtype), slot)
        write_slice(cv, v.to(cv.dtype), slot)
        new_state["ck"], new_state["cv"] = ck, cv
        out = _ring_attention(q, ck, cv, _ring_positions(idx, win, h.device))

    h = shard(h + einsum("bshk,hkd->bsd", out, a["wo"].to(dt)), "batch", "act_seq", None)
    hn2 = rms_norm(h, p["ln2"], cfg.norm_eps)
    m = p["mlp"]
    h = h + swiglu(hn2, m["w_gate"], m["w_up"], m["w_down"])
    return shard(h, "batch", "act_seq", None), (
        new_state if (state is not None or return_state) else None
    )


def _ring_attention(q, ck, cv, ring_pos):
    """Decode attention over a ring cache, float32 inside.  q: (B, 1, H, hd),
    ck / cv: (B, window, K, hd), ring_pos: (window,); slots with
    ring_pos < 0 are masked out."""
    B, S, H, hd = q.shape
    K = ck.shape[2]
    qf = reshape(q.float(), B, S, K, H // K, hd) / math.sqrt(hd)
    s = einsum("bskgd,btkd->bkgst", qf, ck.float())
    s = torch.where(ring_pos >= 0, s, _NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out = einsum("bkgst,btkd->bskgd", pr, cv.float())
    return reshape(out, B, S, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Model assembly
# ---------------------------------------------------------------------------


def _apply_kind(cfg, ex, kind, p, h, *, state, idx, return_state):
    if kind == "rec":
        return _rec_block(cfg, ex, p, h, state=state, return_state=return_state)
    return _attn_block(cfg, ex, p, h, state=state, idx=idx, return_state=return_state)


def init_hybrid_state(cfg: ModelConfig, batch_size: int, dtype=None, device=None) -> dict:
    """Zero decode state: per pattern position, stacked over super-blocks
    (``rest`` over its one layer)."""
    dt = dtype or getattr(torch, cfg.dtype)
    W = cfg.lru_width or cfg.d_model
    hd = cfg.resolved_head_dim
    n_super, rest = _pattern_split(cfg)

    def one(kind, L):
        if kind == "rec":
            return {
                "conv": torch.zeros((L, batch_size, _CONV - 1, W), dtype=dt, device=device),
                "h": torch.zeros((L, batch_size, W), dtype=torch.float32, device=device),
            }
        shape = (L, batch_size, cfg.local_window, cfg.n_kv_heads, hd)
        return {"ck": torch.zeros(shape, dtype=dt, device=device),
                "cv": torch.zeros(shape, dtype=dt, device=device)}

    st: dict[str, Any] = {"super": {str(i): one(k, n_super)
                                    for i, k in enumerate(cfg.block_pattern)}}
    if rest:
        st["rest"] = {str(i): one(k, 1) for i, k in enumerate(rest)}
    return st


def _stack(states: list[dict]) -> dict:
    """Per-layer state dicts -> one dict of ``(L, ...)`` stacks."""
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def hybrid_forward(cfg: ModelConfig, ex: ExecConfig, params: dict, batch: dict, *,
                   return_state: bool = False):
    """Full-sequence forward; every position's logits, as the JAX package
    computes them.  Returns (logits, aux) or (logits, aux, state), the
    state laid out as ``init_hybrid_state``'s."""
    h = embed_lookup(params["embed"], batch["tokens"]).to(getattr(torch, cfg.dtype))
    n_super, rest = _pattern_split(cfg)

    def body(h, p_j):  # one super-block: the pattern's layers in order
        sts = []
        for i, kind in enumerate(cfg.block_pattern):
            h, st = _apply_kind(cfg, ex, kind, p_j[str(i)], h, state=None, idx=None,
                                return_state=return_state)
            sts.append(st)
        return h, sts

    body = ex.remat_wrap(body)
    per_pos: dict[str, list] = {str(i): [] for i in range(len(cfg.block_pattern))}
    for j in range(n_super):
        h, sts = body(h, _layer(params["super"], j))
        for i, st in enumerate(sts):
            per_pos[str(i)].append(st)
    rest_states = []
    for i, kind in enumerate(rest):
        h, st = _apply_kind(cfg, ex, kind, _layer(params["rest"][str(i)], 0), h, state=None,
                            idx=None, return_state=return_state)
        rest_states.append(st)

    logits = _head(cfg, params, h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if not return_state:
        return logits, aux
    state: dict[str, Any] = {"super": {i: _stack(sts) if sts else {}
                                       for i, sts in per_pos.items()}}
    if rest:
        state["rest"] = {str(i): _stack([st]) for i, st in enumerate(rest_states)}
    return logits, aux, state


def hybrid_decode_step(cfg: ModelConfig, ex: ExecConfig, params: dict, state: dict, tokens,
                       idx: int | torch.Tensor):
    """One decode token a row at position ``idx`` (an int, or a 0-d integer
    tensor on the state's device, read there alone: the ring slot is
    ``idx % local_window``).  Each layer's new state is written into
    ``state`` in place, which is returned with the logits."""
    h = embed_lookup(params["embed"], tokens[:, None]).to(getattr(torch, cfg.dtype))
    n_super, rest = _pattern_split(cfg)
    layers = [(params["super"][str(i)], state["super"][str(i)], j, kind)
              for j in range(n_super) for i, kind in enumerate(cfg.block_pattern)]
    layers += [(params["rest"][str(i)], state["rest"][str(i)], 0, kind)
               for i, kind in enumerate(rest)]
    for p, st, j, kind in layers:
        layer_state = {k: v[j] for k, v in st.items()}
        h, new = _apply_kind(cfg, ex, kind, _layer(p, j), h, state=layer_state, idx=idx,
                             return_state=False)
        for k, v in new.items():
            layer_state[k].copy_(v)  # a no-op for the ring caches, written in place
    return _head(cfg, params, h)[:, 0], state
