"""Decoder-only transformer family: dense GQA, MoE, and VLM (M-RoPE).

Layer-stacked parameters (a leading ``(L, ...)`` axis, the JAX package's
tree), run by a Python loop over layers, and a KV-cache decode path.
Full-sequence attention goes through ``_attn_dispatch``: on the
``"pallas"`` route (the default) ``kernels.ops.flash_attention`` (one
query: ``ops.decode_attention``), whose tensors' device picks the kernel
(CUDA) or its plain version (CPU); on the ``"xla"`` route
``chunked_attention``, plain differentiable torch on any device, which
training takes.  Decode against a cache (``_cached_attention``) takes
``ops.decode_attention`` on ``"pallas"``, ``chunked_attention`` on
``"xla"`` and wherever no kernel applies.  The VLM takes precomputed patch
embeddings as a prefix of the token embeddings (the vision frontend is a
stub, as in the JAX package) and 3-D (t, h, w) positions for M-RoPE.

Each block's work is named by ``trace`` spans, timed on the device with
tracing on (and nothing without): ``attn.qkv`` (``ln1``, the q/k/v
products and biases, RoPE or M-RoPE), ``attn.core`` (the cache write and
the attention), ``attn.out`` (the output product and the residual) and
``mlp`` (``ln2``, the MLP or MoE layer and the residual); once a step
``embed`` (the embeddings, a vision batch's patch prefix, the positions)
and ``head`` (the final norm and the head product).  A dropless MoE layer
names its parts inside ``mlp``: ``moe.route`` (the router, its scores,
top k and weights, and with tracing on the per-expert pair count
``moe.pairs``), ``moe.experts`` (the routed experts, dispatch to combine)
and ``moe.shared`` (the shared experts and their sum).

Latent attention (MLA, DeepSeek-V2/V3; ``cfg.mla``) replaces GQA where a
config sets ``kv_lora_rank``: q = W_q h (nope ‖ rope parts a head); the
latent c and the shared rope key from W_kv_a h, c through its own RMSNorm,
RoPE on the rope parts alone, scores scaled by 1 / sqrt(nope + rope).  The
prefill expands c through W_k_b and W_v_b into each head's k_nope and v
and runs the flash kernel; the cache holds (c, rotated rope key) a token,
``(L, B, T, 1, r)`` and ``(L, B, T, 1, rope)``, and the decode runs in the
absorbed form: q_nope W_k_b^T is a latent query, the latent decode kernel
(``ops.mla_decode``) scores (latent ‖ rope) rows and sums latent rows, and
the result goes through W_v_b, then W_o.  A config with
``first_dense_layers`` keeps those layers in a stack of their own,
``dense_blocks`` (an MLP ``dense_d_ff`` wide), before ``blocks``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from .. import trace
from ..configs.base import ModelConfig
from ..kernels import ops
from ..kernels.flash_attention import HEAD_DIMS
from ..kernels.mla_decode import mla_decode_plain
from ..kernels.rotary import rotary_plain
from ..sharding.ctx import (
    bind_ctx,
    einsum,
    embed_lookup,
    gather_for_use,
    mesh_axis_size,
    shard,
    write_slice,
)
from ..kernels.ref import chunked_attention
from .layers import (
    decode_positions,
    dropless_moe,
    moe_aux_loss,
    moe_layer,
    rms_norm,
    route_topk,
    swiglu,
)
from .params import ParamSpec

__all__ = ["ExecConfig", "block_specs", "lm_specs", "lm_forward", "lm_decode_step", "init_cache"]


# The products "dots" keeps for the backward: every matrix product's output
# (einsum runs as these), as jax.checkpoint_policies.checkpoint_dots does.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.baddbmm.default)


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Execution knobs orthogonal to the architecture.

    ``attn_impl`` picks the full-sequence route of attention and the two
    scans: ``"pallas"`` (the default) runs ``kernels.ops``, the hand-written
    kernel on CUDA tensors and its plain version on CPU tensors; ``"xla"``
    runs the JAX package's XLA-branch functions (``chunked_attention``,
    ``ref.ssd_chunked_ref``, ``ref.rglru_ref``) on any device.  The kernels
    have no backward, so training takes ``"xla"``: a kernel asked to run on
    inputs that require grad raises.  ``kv_chunk`` bounds the keys a step of
    ``chunked_attention`` scores (decode scores the whole cache at once, as
    the JAX package does); ``attn_p_dtype`` is the type p and v are rounded
    to for p @ v there.  ``remat`` is activation checkpointing of each
    layer's body under grad (a Griffin super-block's, as the JAX package
    scans it): ``"none"``, ``"dots"`` (keep the matrix products' outputs,
    recompute the rest) or ``"full"`` (keep the layer's inputs alone).
    ``moe_aux_coef`` weighs the MoE load-balance loss in ``Model.loss``.
    ``cp_attention`` is context-parallel attention under an
    ``activation_sharding`` context: the query sequence shards over
    'model' when the head count does not divide that axis (smollm's 9
    heads on a 16-wide axis would otherwise replicate all attention work
    16x); ``"auto"`` decides on the mesh, ``"on"`` / ``"off"`` force it.
    Outside a context ``shard`` is the identity and the knob changes
    nothing.

    ``unroll_causal`` lets a step with a cache skip the part it has not
    filled: decode at ``cache_idx`` scores the cache ``kv_chunk`` keys at a
    time and skips each chunk wholly past ``cache_idx`` (the JAX package's
    unrolled ``chunked_attention`` conditions), where it otherwise scores
    the whole cache as one chunk; wherever decode runs ``chunked_attention``
    (the ``"xla"`` route, and ``"pallas"`` on CPU tensors: ``"pallas"``'s
    decode kernel on the card reads the filled part alone, knob or not).
    The logits are the same up to the order of the
    softmax's sums, and a step at fill f of a T-slot cache scores
    ceil((f + 1) / kv_chunk) chunks instead of T keys.  A full-sequence
    call has no chunk to skip (its last query sees every key), so there
    the knob changes nothing; in the JAX package it also unrolls the
    chunk scan there, which eager torch has no counterpart for.
    ``moe_impl`` is the MoE layer's layout of the experts' slots:
    ``"vmap"`` stacks every row's slots into one (E, B·capacity, D) slab
    a layer, its expert dim split over the mesh ("expert"); ``"batched"``
    keeps a (B, E, capacity, D) buffer split over the batch's and the
    experts' mesh axes, so each device fills and runs only its own
    experts' slots of its own rows and the rows' outputs are summed over
    the expert axis.  Off a mesh both compute the same function (the
    products and the final sums in another order); on a mesh "vmap" runs
    each device's experts for every row, "batched" for its rows alone.
    """

    attn_impl: str = "pallas"  # pallas | xla
    kv_chunk: int = 1024
    unroll_causal: bool = False
    remat: str = "full"  # none | dots | full
    moe_aux_coef: float = 0.01
    cp_attention: str = "auto"  # auto | on | off
    attn_p_dtype: str = "float32"
    moe_impl: str = "vmap"  # vmap | batched

    def __post_init__(self) -> None:
        if self.attn_impl not in ("pallas", "xla"):
            raise ValueError(f"attn_impl {self.attn_impl!r}: want 'pallas' or 'xla'")
        if self.remat not in ("none", "dots", "full"):
            raise ValueError(f"remat {self.remat!r}: want 'none', 'dots' or 'full'")
        if self.cp_attention not in ("auto", "on", "off"):
            raise ValueError(f"cp_attention {self.cp_attention!r}: want 'auto', 'on' or 'off'")
        if self.moe_impl not in ("vmap", "batched"):
            raise ValueError(f"moe_impl {self.moe_impl!r}: want 'vmap' or 'batched'")

    def remat_wrap(self, fn):
        """``fn`` under activation checkpointing when grad is on; without
        grad nothing is kept for a backward, and ``fn`` runs as it is."""
        if self.remat == "none":
            return fn
        context = (functools.partial(create_selective_checkpoint_contexts, list(_DOTS))
                   if self.remat == "dots" else noop_context_fn)

        def wrapped(*args, **kwargs):
            if not torch.is_grad_enabled():
                return fn(*args, **kwargs)
            # the recompute places its activations as the forward did
            return checkpoint(bind_ctx(fn), *args, use_reentrant=False, preserve_rng_state=False,
                              context_fn=context, **kwargs)

        return wrapped


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


# The port-only fields (latent attention, leading dense layers, DeepSeek's
# router) read with their defaults: these functions also take the JAX
# package's configs, which lack them (the CPU parity tests pass those).
def _is_mla(cfg) -> bool:
    return getattr(cfg, "kv_lora_rank", 0) > 0


def _moe_field(cfg, name: str, default=0):
    return getattr(cfg.moe, name, default)


def attn_specs(cfg: ModelConfig, L: int) -> dict[str, ParamSpec]:
    D, H, K = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    s: dict[str, ParamSpec] = {
        "wq": ParamSpec((L, D, H, hd), ("layers", "embed", "heads", None)),
        "wk": ParamSpec((L, D, K, hd), ("layers", "embed", "kv", None)),
        "wv": ParamSpec((L, D, K, hd), ("layers", "embed", "kv", None)),
        "wo": ParamSpec((L, H, hd, D), ("layers", "heads", None, "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((L, H, hd), ("layers", "heads", None), init="zeros")
        s["bk"] = ParamSpec((L, K, hd), ("layers", "kv", None), init="zeros")
        s["bv"] = ParamSpec((L, K, hd), ("layers", "kv", None), init="zeros")
    return s


def mla_specs(cfg: ModelConfig, L: int) -> dict[str, ParamSpec]:
    """Latent attention's leaves (``q_lora_rank`` null: q straight from h)."""
    D, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq": ParamSpec((L, D, H, nope + rope), ("layers", "embed", "heads", None)),
        "wkv_a": ParamSpec((L, D, r + rope), ("layers", "embed", None)),
        "kv_norm": ParamSpec((L, r), ("layers", None), init="zeros"),
        "wk_b": ParamSpec((L, r, H, nope), ("layers", None, "heads", None)),
        "wv_b": ParamSpec((L, r, H, vd), ("layers", None, "heads", None)),
        "wo": ParamSpec((L, H, vd, D), ("layers", "heads", None, "embed")),
    }


def mlp_specs(cfg: ModelConfig, L: int, F: int | None = None) -> dict[str, ParamSpec]:
    D, F = cfg.d_model, F or cfg.d_ff
    return {
        "w_gate": ParamSpec((L, D, F), ("layers", "embed", "mlp")),
        "w_up": ParamSpec((L, D, F), ("layers", "embed", "mlp")),
        "w_down": ParamSpec((L, F, D), ("layers", "mlp", "embed")),
    }


def moe_specs(cfg: ModelConfig, L: int) -> dict[str, ParamSpec]:
    assert cfg.moe is not None
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    s: dict[str, Any] = {
        "router": ParamSpec((L, D, E), ("layers", "embed", None)),
        "w_gate": ParamSpec((L, E, D, F), ("layers", "expert", "embed", None)),
        "w_up": ParamSpec((L, E, D, F), ("layers", "expert", "embed", None)),
        "w_down": ParamSpec((L, E, F, D), ("layers", "expert", None, "embed")),
    }
    if _moe_field(cfg, "correction_bias", False):
        s["bias"] = ParamSpec((L, E), ("layers", None), init="zeros")
    if _moe_field(cfg, "n_shared"):
        s["shared"] = mlp_specs(cfg, L, cfg.moe.n_shared * F)
    return s


def block_specs(cfg: ModelConfig, L: int, *, dense: bool = False) -> dict[str, Any]:
    """``L`` stacked blocks; ``dense``: the leading dense layers' (an MLP
    ``dense_d_ff`` wide in a MoE model)."""
    s: dict[str, Any] = {
        "ln1": ParamSpec((L, cfg.d_model), ("layers", "embed"), init="zeros"),
        "ln2": ParamSpec((L, cfg.d_model), ("layers", "embed"), init="zeros"),
        "attn": mla_specs(cfg, L) if _is_mla(cfg) else attn_specs(cfg, L),
    }
    if dense:
        s["mlp"] = mlp_specs(cfg, L, cfg.dense_d_ff)
    elif cfg.family == "moe":
        s["moe"] = moe_specs(cfg, L)
    else:
        s["mlp"] = mlp_specs(cfg, L)
    return s


def _groups(cfg: ModelConfig) -> list[tuple[str, int]]:
    """The stacks of blocks in layer order: (tree key, layers)."""
    n = getattr(cfg, "first_dense_layers", 0)
    return [("dense_blocks", n)] * (n > 0) + [("blocks", cfg.n_layers - n)]


def lm_specs(cfg: ModelConfig) -> dict[str, Any]:
    V, D = cfg.vocab, cfg.d_model
    s: dict[str, Any] = {
        "embed": ParamSpec((V, D), ("vocab", "embed"), init="embed"),
        "final_ln": ParamSpec((D,), ("embed",), init="zeros"),
    }
    for key, n in _groups(cfg):
        s[key] = block_specs(cfg, n, dense=key == "dense_blocks")
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((D, V), ("embed", "vocab"))
    return s


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layers(cfg: ModelConfig, params: dict):
    """Each layer's parameters (``_layer``), in order over the stacks."""
    for key, n in _groups(cfg):
        for i in range(n):
            yield _layer(params[key], i)


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s slice of a stacked ``(L, ...)`` parameter tree (views;
    under ``activation_sharding``, gathered over the batch's mesh axes for
    use, ZeRO-3's all-gather of FSDP shards)."""
    return {k: _layer(v, i) if isinstance(v, dict) else gather_for_use(v[i])
            for k, v in tree.items()}


def _qkv(cfg: ModelConfig, ex: ExecConfig, p: dict, hn, pos, *, cached: bool):
    """The attention's q, k and v of ``hn``, biased, sharded and rotated."""
    dt = hn.dtype
    q = einsum("bsd,dhk->bshk", hn, p["wq"].to(dt))
    k = einsum("bsd,dhk->bshk", hn, p["wk"].to(dt))
    v = einsum("bsd,dhk->bshk", hn, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    # Context-parallel attention: when heads don't fill the 'model' axis,
    # shard the query sequence over it instead, so scores go
    # (B, K, g, S/model, T) a device rather than replicated.
    tp = mesh_axis_size("model")
    cp = ex.cp_attention == "on" or (
        ex.cp_attention == "auto"
        and tp is not None
        and not cached  # full-sequence paths only
        and cfg.n_heads % tp != 0
    )
    q = shard(q, "batch", "act_seq" if cp else "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv", None)
    v = shard(v, "batch", "seq", "kv", None)
    if cfg.rope != "none":
        q, k = _rotary(ex, q, k, pos, cfg.rope_theta,
                       cfg.mrope_sections if cfg.rope == "mrope" else None)
    return q, k, v


def _rotary(ex: ExecConfig, q, k, pos, theta: float, sections: tuple[int, ...] | None = None):
    """RoPE (``sections`` None) or M-RoPE of q and k on ``ex.attn_impl``'s
    route: ``"pallas"`` takes ``ops.rotary`` (kernel 8 on CUDA tensors,
    which rotates q and k in place), ``"xla"`` the plain route,
    ``layers.apply_rope`` / ``apply_mrope``.  Returns the rotated pair."""
    rotate = ops.rotary if ex.attn_impl == "pallas" else rotary_plain
    return rotate(q, k, pos, theta, sections)


def _attend(ex: ExecConfig, q, k, v, *, cache, cache_idx):
    """Attention of the step's q, k and v.  Returns (out, (k, v)).

    With a cache (one layer's ``(B, T, K, hd)`` pair), the step's k and v
    are written into it in place at ``cache_idx`` and it is returned.
    """
    if cache is None:
        return _attn_dispatch(ex, q, k, v, causal=True, window=0), (k, v)  # prefill fills it
    ck, cv = cache
    write_slice(ck, k.to(ck.dtype), cache_idx)
    write_slice(cv, v.to(cv.dtype), cache_idx)
    return _cached_attention(ex, q, ck, cv, cache_idx), (ck, cv)


def _attn_dispatch(ex: ExecConfig, q, k, v, *, causal: bool, window: int,
                   scale: float | None = None) -> torch.Tensor:
    """Full-sequence attention (q from position 0 against every key) on
    ``ex.attn_impl``'s route; one query scores all T keys at once, as the
    JAX package's decode does.  ``scale`` None: 1 / sqrt(hd)."""
    S, T = q.shape[1], k.shape[1]
    if ex.attn_impl == "pallas":
        if S == 1:
            return ops.decode_attention(q, k, v, causal=causal, window=window,
                                        p_dtype=ex.attn_p_dtype, scale=scale)
        return ops.flash_attention(q, k, v, causal=causal, window=window, scale=scale)
    # no chunk here lies past the last query (ex.unroll_causal: nothing to skip)
    return chunked_attention(q, k, v, q_offset=0, causal=causal, window=window,
                             kv_chunk=T if S == 1 else min(ex.kv_chunk, T),
                             p_dtype=ex.attn_p_dtype, scale=scale)


def _padded_attention(ex: ExecConfig, q, k, v, scale: float) -> torch.Tensor:
    """Causal attention of q, k (B, S, H, dk) and v (B, S, H, dv) of other
    widths (latent attention's 192 and 128): all three zero-padded to the
    smallest head width the flash kernel is built for that holds both
    (256), and the output's pad columns dropped.  Exact: a zero column adds
    nothing to a score and gives a zero output column.  It costs the
    kernel 256 / 192 of the score products and 2x the value products."""
    dv = v.shape[-1]
    hd = next(w for w in HEAD_DIMS if w >= max(q.shape[-1], dv))
    q, k, v = (F.pad(t, (0, hd - t.shape[-1])) for t in (q, k, v))
    return _attn_dispatch(ex, q, k, v, causal=True, window=0, scale=scale)[..., :dv]


def _cached_attention(ex: ExecConfig, q, ck, cv, cache_idx) -> torch.Tensor:
    """The step's queries at ``cache_idx`` against a ``(B, T, K, hd)``
    cache filled to ``cache_idx + S``: one chunk of T keys for decode,
    ``kv_chunk`` keys a chunk, the unfilled ones skipped, under
    ``ex.unroll_causal`` (see ``ExecConfig``), on ``ex.attn_impl``'s route.
    No kernel takes more than one query against a cache, nor the skipping
    on CPU tensors (on the card kernel 6 reads the filled keys alone)."""
    S, T = q.shape[1], ck.shape[1]
    k, v = ck.to(q.dtype), cv.to(q.dtype)
    unroll = ex.unroll_causal and isinstance(cache_idx, int)
    if ex.attn_impl == "pallas" and S == 1 and not (unroll and q.device.type != "cuda"):
        return ops.decode_attention(q, k, v, q_offset=cache_idx, kv_len=cache_idx + 1,
                                    p_dtype=ex.attn_p_dtype)
    return chunked_attention(
        q, k, v, q_offset=cache_idx, kv_len=cache_idx + S, causal=True, window=0,
        kv_chunk=T if S == 1 and not unroll else min(ex.kv_chunk, T),
        unroll_causal=unroll, p_dtype=ex.attn_p_dtype,
    )


def _mla(cfg: ModelConfig, ex: ExecConfig, p: dict, h, pos, *, cache, cache_idx):
    """Latent attention and its residual (see the module's docstring), in
    the spans ``attn.qkv`` (ln1, the q and kv_a products, the latent's norm,
    RoPE; the prefill's expansion of c into k_nope and v, the decode's
    absorbed query q_nope W_k_b^T), ``attn.core`` (the cache write and the
    attention; the decode's on ``ex.attn_impl``'s route, kernel 7 through
    ``ops.mla_decode`` or ``mla_decode_plain``) and ``attn.out`` (the decode's W_v_b, W_o, the residual).
    Returns (h, cache: (c, rope key) each ``(B, T, 1, width)``, the last
    span)."""
    if cache is not None and ex.attn_p_dtype != "float32":
        raise NotImplementedError(f"attn_p_dtype {ex.attn_p_dtype!r}: latent decode attention "
                                  "runs p in float32 on either route")
    dev, a = h.device, p["attn"]
    r, nope = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    scale = (nope + cfg.qk_rope_head_dim) ** -0.5
    with trace.span("attn.qkv", dev) as part:
        hn = rms_norm(h, p["ln1"], cfg.norm_eps)
        dt = hn.dtype
        q = einsum("bsd,dhk->bshk", hn, a["wq"].to(dt))
        kv = einsum("bsd,dk->bsk", hn, a["wkv_a"].to(dt))
        c = rms_norm(kv[..., :r], a["kv_norm"], cfg.norm_eps)[:, :, None]  # (B, S, 1, r)
        # the rope columns of q and the rope key (B, S, 1, rope); the
        # kernel rotates them where they lie, in q and kv
        q_nope, q_rope = q[..., :nope], q[..., nope:]
        rotated, kr = _rotary(ex, q_rope, kv[:, :, None, r:], pos, cfg.rope_theta)
        if cache is None:  # each head's q, k (nope ‖ rope) and v
            if rotated is not q_rope:  # the plain route's new tensor
                q = torch.cat([q_nope, rotated], dim=-1)
            kr = kr.contiguous()  # the cache's rope key, apart from kv
            k = torch.cat([einsum("bsr,rhn->bshn", c[:, :, 0], a["wk_b"].to(dt)),
                           kr.expand(-1, -1, cfg.n_heads, -1)], dim=-1)
            v = einsum("bsr,rhv->bshv", c[:, :, 0], a["wv_b"].to(dt))
        else:  # the absorbed query (B, H, r + rope)
            q = torch.cat([einsum("bhn,rhn->bhr", q_nope[:, 0], a["wk_b"].to(dt)),
                           rotated[:, 0]], dim=-1)
        del hn, q_nope, q_rope, rotated, kv
    with trace.span("attn.core", dev, after=part) as part:
        if cache is None:
            out = _padded_attention(ex, q, k, v, scale)
            new_cache = (c, kr)
            del k, v
        else:
            cc, ck = new_cache = cache
            write_slice(cc, c.to(cc.dtype), cache_idx)
            write_slice(ck, kr.to(ck.dtype), cache_idx)
            attend = ops.mla_decode if ex.attn_impl == "pallas" else mla_decode_plain
            o_lat = attend(q, cc[:, :, 0], ck[:, :, 0], kv_len=cache_idx + 1, scale=scale)
        del q
    with trace.span("attn.out", dev, after=part) as part:
        if cache is not None:
            out = einsum("bhr,rhv->bhv", o_lat, a["wv_b"].to(dt))[:, None]
        h = h + einsum("bshv,hvd->bsd", out, a["wo"].to(dt))
    return h, new_cache, part


def _moe(cfg: ModelConfig, m: dict, hn) -> torch.Tensor:
    """A dropless MoE layer (``layers.route_topk``, ``layers.dropless_moe``)
    and its shared experts, in the spans ``moe.route``, ``moe.experts`` and
    ``moe.shared``; with tracing on ``moe.pairs`` counts each expert's
    routed pairs on the device."""
    spec, dev = cfg.moe, hn.device
    B, S, D = hn.shape
    x = hn.reshape(B * S, D)
    with trace.span("moe.route", dev) as part:
        idx, w = route_topk(x, m["router"], m.get("bias"), top_k=spec.top_k,
                            scoring=spec.scoring, norm_topk=spec.norm_topk,
                            scale=spec.routed_scale)
        trace.tally("moe.pairs", idx, spec.n_experts)
    with trace.span("moe.experts", dev, after=part) as part:
        y = dropless_moe(x, idx, w, m["w_gate"], m["w_up"], m["w_down"]).reshape(B, S, D)
    if "shared" in m:
        with trace.span("moe.shared", dev, after=part):
            sh = m["shared"]
            y = y + swiglu(hn, sh["w_gate"], sh["w_up"], sh["w_down"])
    return y


def _block_apply(cfg: ModelConfig, ex: ExecConfig, p: dict, h, pos, *, cache, cache_idx):
    """One block.  Returns (h, router probs or None, cache)."""
    dev = h.device
    if _is_mla(cfg):
        h, new_cache, part = _mla(cfg, ex, p, h, pos, cache=cache, cache_idx=cache_idx)
    else:
        with trace.span("attn.qkv", dev) as part:
            h = shard(h, "batch", "act_seq", None)
            hn = rms_norm(h, p["ln1"], cfg.norm_eps)
            q, k, v = _qkv(cfg, ex, p["attn"], hn, pos, cached=cache is not None)
        with trace.span("attn.core", dev, after=part) as part:
            out, new_cache = _attend(ex, q, k, v, cache=cache, cache_idx=cache_idx)
        with trace.span("attn.out", dev, after=part) as part:
            attn_out = einsum("bshk,hkd->bsd", out, p["attn"]["wo"].to(hn.dtype))
            # freed here, as the attention's own temporaries were: a captured
            # prefill's pool holds the same blocks with tracing on or off
            del q, k, v, out
            h = h + attn_out
    with trace.span("mlp", dev, after=part):
        h = shard(h, "batch", "act_seq", None)
        hn2 = rms_norm(h, p["ln2"], cfg.norm_eps)
        probs = None
        if "mlp" in p:
            m = p["mlp"]
            y = swiglu(hn2, m["w_gate"], m["w_up"], m["w_down"])
        elif _moe_field(cfg, "dropless", False):
            y = _moe(cfg, p["moe"], hn2)
        else:
            m = p["moe"]
            y, probs = moe_layer(hn2, m["router"], m["w_gate"], m["w_up"], m["w_down"],
                                 top_k=cfg.moe.top_k, capacity_factor=cfg.moe.capacity,
                                 impl=ex.moe_impl)
        h = shard(h + y, "batch", "act_seq", None)
    return h, probs, new_cache


def _logits(cfg: ModelConfig, params: dict, h) -> torch.Tensor:
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = einsum("bsd,dv->bsv", h, head.to(h.dtype))
    return shard(logits, "batch", "seq", "vocab")


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return embed_lookup(params["embed"], tokens).to(getattr(torch, cfg.dtype))


def _embed_inputs(cfg: ModelConfig, params: dict, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Token embeddings, behind the patch-embedding prefix of a vision
    batch.  Returns (h, positions): the batch's, or 0..S-1 in every stream
    ((B, S, 3) for M-RoPE, (B, S) otherwise)."""
    h = _embed(cfg, params, batch["tokens"])
    if cfg.modality == "vision" and "patch_embeds" in batch:
        h = torch.cat([batch["patch_embeds"].to(h.dtype), h], dim=1)
    h = shard(h, "batch", "act_seq", None)
    pos = batch.get("positions")
    if pos is None:
        B, S = h.shape[0], h.shape[1]
        pos = torch.arange(S, device=h.device)[None, :].expand(B, S)
        if cfg.rope == "mrope":
            pos = pos[..., None].expand(B, S, 3)
    return h, pos


def lm_forward(
    cfg: ModelConfig,
    ex: ExecConfig,
    params: dict,
    batch: dict,
    *,
    return_cache: bool = False,
):
    """Full-sequence forward (train / prefill).

    Returns (logits, aux_loss) or (logits, aux_loss, cache); the cache is
    the stacked ``(L, B, S, K, hd)`` K/V pair for decode continuation, and
    aux_loss the float32 sum of the MoE layers' load-balance losses (0
    without MoE).
    """
    with trace.span("embed", batch["tokens"].device):
        h, pos = _embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    ks, vs = [], []
    block = ex.remat_wrap(_block_apply)
    for p in _layers(cfg, params):
        h, probs, (k, v) = block(cfg, ex, p, h, pos, cache=None, cache_idx=None)
        if probs is not None:
            aux = aux + moe_aux_loss(probs, cfg.moe.top_k)
        if return_cache:
            ks.append(k)
            vs.append(v)
    with trace.span("head", h.device):
        logits = _logits(cfg, params, h)
    if return_cache:
        return logits, aux, (torch.stack(ks), torch.stack(vs))
    return logits, aux


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype=None, device=None):
    """Zero KV cache, stacked over layers: (L, B, T, K, hd) x2; under latent
    attention the latent and the rope key, (L, B, T, 1, r) and
    (L, B, T, 1, rope)."""
    dt = dtype or getattr(torch, cfg.dtype)
    lead = (cfg.n_layers, batch_size, max_len)
    if _is_mla(cfg):
        widths = ((1, cfg.kv_lora_rank), (1, cfg.qk_rope_head_dim))
    else:
        widths = ((cfg.n_kv_heads, cfg.resolved_head_dim),) * 2
    return tuple(torch.zeros((*lead, *w), dtype=dt, device=device) for w in widths)


def abstract_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype=None):
    """``init_cache``'s (k, v) shapes and dtypes, as tensors on the ``meta``
    device (the JAX package's ``ShapeDtypeStruct``s): nothing allocated."""
    return init_cache(cfg, batch_size, max_len, dtype, device=torch.device("meta"))


def lm_decode_step(
    cfg: ModelConfig,
    ex: ExecConfig,
    params: dict,
    cache,
    tokens: torch.Tensor,  # (B,) next-token ids
    idx: int | torch.Tensor,  # current cache fill
):
    """One decode step: write the token's K/V at ``idx`` (an int, or a 0-d
    integer tensor on the cache's device, read there alone) of every
    layer's cache, in place, and return (logits, cache)."""
    B = tokens.shape[0]
    with trace.span("embed", tokens.device):
        h = _embed(cfg, params, tokens[:, None])  # (B,1,D)
        shape = (B, 1, 3) if cfg.rope == "mrope" else (B, 1)  # M-RoPE: t = h = w = idx
        pos = decode_positions(idx, shape, h.device)
    for i, p in enumerate(_layers(cfg, params)):
        h, _, _ = _block_apply(cfg, ex, p, h, pos, cache=(cache[0][i], cache[1][i]),
                               cache_idx=idx)
    with trace.span("head", h.device):
        logits = _logits(cfg, params, h)[:, 0]
    return logits, cache
