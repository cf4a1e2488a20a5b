"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060), attention-free LM.

The full-sequence forward runs the chunked dual form through
``kernels.ops.ssd_scan`` on the ``"pallas"`` route (the SSD kernel on CUDA
tensors, its plain version on CPU tensors) and through
``ref.ssd_chunked_ref`` on the ``"xla"`` route (training's); decode
carries an O(1) per-layer state (the last K-1 pre-conv inputs and the
float32 SSD state) and runs ``ref.ssd_decode_step``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from ..kernels import ref as kref
from ..sharding.ctx import channelwise, einsum, embed_lookup, reshape, shard
from .layers import rms_norm
from .params import ParamSpec
from .transformer import ExecConfig, _layer

__all__ = ["ssm_specs", "ssm_forward", "ssm_decode_step", "init_ssm_state", "abstract_ssm_state"]


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.ssm_head_dim
    ng = 1  # single B/C group (mamba2-130m)
    return di, nh, ng, cfg.ssm_state


def block_specs(cfg: ModelConfig, L: int) -> dict[str, ParamSpec]:
    D = cfg.d_model
    di, nh, ng, ds = _dims(cfg)
    K = cfg.ssm_conv
    return {
        "ln": ParamSpec((L, D), ("layers", "embed"), init="zeros"),
        "w_z": ParamSpec((L, D, di), ("layers", "embed", "mlp")),
        "w_x": ParamSpec((L, D, di), ("layers", "embed", "mlp")),
        "w_B": ParamSpec((L, D, ng * ds), ("layers", "embed", "state")),
        "w_C": ParamSpec((L, D, ng * ds), ("layers", "embed", "state")),
        "w_dt": ParamSpec((L, D, nh), ("layers", "embed", None)),
        "dt_bias": ParamSpec((L, nh), ("layers", None), init="zeros"),
        "conv_x": ParamSpec((L, K, di), ("layers", "conv", "mlp"), init="normal"),
        "conv_B": ParamSpec((L, K, ng * ds), ("layers", "conv", "state"), init="normal"),
        "conv_C": ParamSpec((L, K, ng * ds), ("layers", "conv", "state"), init="normal"),
        "A_log": ParamSpec((L, nh), ("layers", None), init="zeros"),
        "Dskip": ParamSpec((L, nh), ("layers", None), init="ones"),
        "gn": ParamSpec((L, di), ("layers", "mlp"), init="zeros"),
        "w_out": ParamSpec((L, di, D), ("layers", "mlp", "embed")),
    }


def ssm_specs(cfg: ModelConfig) -> dict[str, Any]:
    # The JAX package keeps a separate lm_head although the config says
    # tie_embeddings=True; the port keeps the same tree.
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), init="embed"),
        "final_ln": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        "blocks": block_specs(cfg, cfg.n_layers),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, C), w: (K, C).

    The K-tap shifted sum, in the JAX package's order of summation (and not
    ``F.conv1d``, which cuDNN runs in TF32 for float32 by default); on
    DTensors, on each device's channels (``channelwise``)."""
    return channelwise(_causal_conv_local, x, w)


def _causal_conv_local(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    S = x.shape[1]
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + pad[:, k : k + S] * w[k].to(x.dtype)
    return out


def _conv_step(state: torch.Tensor, x: torch.Tensor, w: torch.Tensor):
    """Single-token conv.  state: (B, K-1, C), x: (B, C).  -> (y, new_state)."""
    full = torch.cat([state, x[:, None]], dim=1)  # (B, K, C)
    y = einsum("bkc,kc->bc", full, w.to(x.dtype))
    return y, full[:, 1:]


def _block(cfg: ModelConfig, ex: ExecConfig, p: dict, h, *, state, return_state):
    """One mamba2 block.  h: (B, S, D).  state: one layer's dict or None."""
    di, nh, ng, ds = _dims(cfg)
    hp = cfg.ssm_head_dim
    dt_ = h.dtype
    h = shard(h, "batch", "act_seq", None)
    hn = rms_norm(h, p["ln"], cfg.norm_eps)

    z = shard(einsum("bsd,de->bse", hn, p["w_z"].to(dt_)), "batch", "seq", "mlp")
    x = shard(einsum("bsd,de->bse", hn, p["w_x"].to(dt_)), "batch", "seq", "mlp")
    Bm = shard(einsum("bsd,de->bse", hn, p["w_B"].to(dt_)), "batch", "seq", "state")
    Cm = shard(einsum("bsd,de->bse", hn, p["w_C"].to(dt_)), "batch", "seq", "state")
    dt = shard(einsum("bsd,dh->bsh", hn, p["w_dt"].to(dt_)), "batch", "seq", None)

    new_state = {}
    if state is None:
        xc = _causal_conv(x, p["conv_x"])
        Bc = _causal_conv(Bm, p["conv_B"])
        Cc = _causal_conv(Cm, p["conv_C"])
        if return_state:
            K = cfg.ssm_conv
            # conv tail: last K-1 *pre-conv* inputs
            new_state["conv_x"] = x[:, -(K - 1) :].to(dt_)
            new_state["conv_B"] = Bm[:, -(K - 1) :].to(dt_)
            new_state["conv_C"] = Cm[:, -(K - 1) :].to(dt_)
    else:
        # decode: S == 1
        xc1, new_state["conv_x"] = _conv_step(state["conv_x"], x[:, 0], p["conv_x"])
        Bc1, new_state["conv_B"] = _conv_step(state["conv_B"], Bm[:, 0], p["conv_B"])
        Cc1, new_state["conv_C"] = _conv_step(state["conv_C"], Cm[:, 0], p["conv_C"])
        xc, Bc, Cc = xc1[:, None], Bc1[:, None], Cc1[:, None]

    xc = F.silu(xc.float()).to(dt_)
    Bc = F.silu(Bc.float()).to(dt_)
    Cc = F.silu(Cc.float()).to(dt_)
    dtp = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    Dskip = p["Dskip"].float()

    B_, S_ = xc.shape[0], xc.shape[1]
    xh = reshape(xc, B_, S_, nh, hp)
    Bg = reshape(Bc, B_, S_, ng, ds)
    Cg = reshape(Cc, B_, S_, ng, ds)

    if state is None:
        if ex.attn_impl == "pallas":
            out = ops.ssd_scan(xh, dtp, A, Bg, Cg, Dskip, chunk=cfg.ssm_chunk,
                               return_state=return_state)
        else:
            chunk = min(cfg.ssm_chunk, S_)
            while S_ % chunk:  # largest divisor of S not exceeding ssm_chunk
                chunk -= 1
            out = kref.ssd_chunked_ref(xh, dtp, A, Bg, Cg, Dskip, chunk=chunk,
                                       return_state=return_state)
        if return_state:
            y, new_state["ssm"] = out
        else:
            y = out
    else:
        y1, new_state["ssm"] = kref.ssd_decode_step(
            state["ssm"], xh[:, 0], dtp[:, 0], A, Bg[:, 0], Cg[:, 0], Dskip
        )
        y = y1[:, None]

    y = reshape(y, B_, S_, di)
    y = y * F.silu(z.float()).to(dt_)
    y = shard(rms_norm(y, p["gn"], cfg.norm_eps), "batch", "seq", "mlp")
    out = einsum("bse,ed->bsd", y, p["w_out"].to(dt_))
    return shard(h + out, "batch", "act_seq", None), (
        new_state if (state is not None or return_state) else None
    )


def init_ssm_state(cfg: ModelConfig, batch_size: int, dtype=None, device=None) -> dict:
    """Zero decode state, stacked over layers."""
    dt = dtype or getattr(torch, cfg.dtype)
    di, nh, ng, ds = _dims(cfg)
    hp = cfg.ssm_head_dim
    L, K = cfg.n_layers, cfg.ssm_conv
    kw = dict(device=device)
    return {
        "conv_x": torch.zeros((L, batch_size, K - 1, di), dtype=dt, **kw),
        "conv_B": torch.zeros((L, batch_size, K - 1, ng * ds), dtype=dt, **kw),
        "conv_C": torch.zeros((L, batch_size, K - 1, ng * ds), dtype=dt, **kw),
        "ssm": torch.zeros((L, batch_size, nh, ds, hp), dtype=torch.float32, **kw),
    }


def abstract_ssm_state(cfg: ModelConfig, batch_size: int, dtype=None) -> dict:
    """``init_ssm_state``'s tree as meta tensors: its shapes and dtypes, no
    allocation."""
    return init_ssm_state(cfg, batch_size, dtype, device="meta")


def _head(cfg: ModelConfig, params: dict, h) -> torch.Tensor:
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return einsum("bsd,dv->bsv", h, params["lm_head"].to(h.dtype))


def ssm_forward(
    cfg: ModelConfig,
    ex: ExecConfig,
    params: dict,
    batch: dict,
    *,
    return_state: bool = False,
):
    """Full-sequence forward.  Returns (logits, aux) or (logits, aux, state),
    the state stacked over layers as ``init_ssm_state`` lays it out."""
    h = embed_lookup(params["embed"], batch["tokens"]).to(getattr(torch, cfg.dtype))
    sts = []
    block = ex.remat_wrap(_block)
    for i in range(cfg.n_layers):
        h, st = block(cfg, ex, _layer(params["blocks"], i), h, state=None,
                      return_state=return_state)
        sts.append(st)
    logits = _head(cfg, params, h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if return_state:
        return logits, aux, {k: torch.stack([st[k] for st in sts]) for k in sts[0]}
    return logits, aux


def ssm_decode_step(cfg: ModelConfig, ex: ExecConfig, params: dict, state: dict, tokens, idx):
    """One decode token.  tokens: (B,); idx unused (the state is
    position-free).  Each layer's new state is written into ``state`` in
    place, which is returned with the logits."""
    del idx
    h = embed_lookup(params["embed"], tokens[:, None]).to(getattr(torch, cfg.dtype))
    for i in range(cfg.n_layers):
        layer_state = {k: v[i] for k, v in state.items()}
        h, new = _block(cfg, ex, _layer(params["blocks"], i), h, state=layer_state,
                        return_state=False)
        for k, v in new.items():
            layer_state[k].copy_(v)
    return _head(cfg, params, h)[:, 0], state
