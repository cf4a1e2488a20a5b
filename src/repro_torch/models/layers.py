"""Shared neural layers: RMS norm, rotary embeddings, attention, SwiGLU, MoE.

Functions over tensors; parameters arrive as (sub)trees of the spec
functions in the sibling model files.  The cast points are the JAX
package's: norms, RoPE, the softmax and the SiLU in float32, the products
in the activations' type (``cfg.dtype``).

The plain attention and rotary functions live beside their kernels and
are named here as the JAX package's ``layers`` names them:
``chunked_attention``, the online-softmax attention in plain torch ops
(``kernels.ref``), and ``make_rope_freqs``, ``apply_rope`` and
``apply_mrope`` (``kernels.rotary``).  The MoE layer's expert products are
batched matrix products (cuBLAS on the card), as the JAX package runs them
outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ref import chunked_attention
from ..kernels.rotary import apply_mrope, apply_rope, make_rope_freqs
from ..sharding.ctx import einsum, expertwise, mean, reshape, rowwise, shard

__all__ = [
    "rms_norm",
    "make_rope_freqs",
    "apply_rope",
    "apply_mrope",
    "decode_positions",
    "chunked_attention",
    "swiglu",
    "moe_layer",
    "moe_aux_loss",
    "route_topk",
    "dropless_moe",
]

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    rms = torch.sqrt(mean(xf * xf, -1, keepdim=True) + eps)
    return ((xf / rms) * (1.0 + scale.float())).to(x.dtype)


def decode_positions(idx: int | torch.Tensor, shape: tuple[int, ...], device) -> torch.Tensor:
    """A long tensor of ``shape`` holding the decode position ``idx`` in
    every entry: filled from an int, or broadcast from a 0-d integer tensor
    on ``device`` (a captured step's position) without a read on the host."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.long).expand(shape)
    return torch.full(shape, idx, dtype=torch.long, device=device)


# ---------------------------------------------------------------------------
# Feed-forward
# ---------------------------------------------------------------------------


def swiglu(
    x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor
) -> torch.Tensor:
    dt = x.dtype
    g = einsum("bsd,df->bsf", x, w_gate.to(dt))
    u = einsum("bsd,df->bsf", x, w_up.to(dt))
    h = F.silu(g.float()).to(dt) * u
    h = shard(h, "batch", "seq", "mlp")
    return einsum("bsf,fd->bsd", h, w_down.to(dt))


# ---------------------------------------------------------------------------
# Mixture-of-Experts: sort-based capacity dispatch, one routing group a
# batch row, into contiguous expert slabs run as batched matrix products
# ---------------------------------------------------------------------------


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, largest first and ties to the
    lower index (``lax.top_k``'s order; ``torch.topk`` leaves ties open)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_layer(
    x: torch.Tensor,
    router: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    top_k: int,
    capacity_factor: float,
    impl: str = "vmap",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed MoE over groups = batch rows.  x: (B, S, D).

    Returns (out, router_probs (B, S, E)); the probs feed the load-balance
    loss.  Expert weights: (E, D, F) / (E, F, D).  Each row routes on its
    own, as the JAX package's per-group routing does: float32 router
    logits and softmax, the top k renormalised, the (token, slot) pairs
    flattened token-major and stably sorted by expert, each expert's first
    ``capacity = ceil(S*k/E*cf)`` pairs kept and the rest dropped (written
    to a sacrificial slot, their output zero).  The routing is row-local
    (``rowwise``: on DTensors, each device's own rows).

    ``impl`` lays out the experts' slots (``ExecConfig.moe_impl``):
    ``"vmap"`` stacks every row's into (E, B·capacity, D) slabs split on
    the experts alone, and brings the outputs back to the rows;
    ``"batched"`` keeps the (B, E, capacity, D) buffer split on the rows
    and the experts (``expertwise``: each device fills its own experts'
    slots from its own rows), and each row's outputs are a sum over the
    experts' shards.
    """
    B, S, D = x.shape
    E = router.shape[1]
    dt = x.dtype
    capacity = max(1, int(math.ceil(S * top_k / E * capacity_factor)))
    x = shard(x, "batch", "seq", None)

    if impl == "batched":
        probs, *route = rowwise(_route, (x,), (router,), top_k=top_k, capacity=capacity)
        (buf,) = expertwise(_slots, (x, *route), weight=w_gate, partial=False, top_k=top_k,
                            capacity=capacity)
        buf = shard(buf[:, :, :capacity], "batch", "expert", None, None)
        g = einsum("becd,edf->becf", buf, w_gate.to(dt))
        u = einsum("becd,edf->becf", buf, w_up.to(dt))
        h = shard(F.silu(g.float()).to(dt) * u, "batch", "expert", None, None)
        y = shard(einsum("becf,efd->becd", h, w_down.to(dt)), "batch", "expert", None, None)
        (out,) = expertwise(_combine, route, (y,), weight=w_gate, partial=True, top_k=top_k)
        return shard(out, "batch", "seq", None), shard(probs, "batch", "seq", None)

    probs, buf, *route = rowwise(_dispatch, (x,), (router,), top_k=top_k, capacity=capacity)
    # the experts' slabs, every row's stacked: (E, B * capacity, D)
    # Expert parallelism: each device runs only its local experts.
    slab = shard(buf[:, :, :capacity].transpose(0, 1).reshape(E, B * capacity, D),
                 "expert", None, None)
    g = torch.bmm(slab, w_gate.to(dt))
    u = torch.bmm(slab, w_up.to(dt))
    h = shard(F.silu(g.float()).to(dt) * u, "expert", None, None)
    y = shard(torch.bmm(h, w_down.to(dt)), "expert", None, None)
    y = y.reshape(E, B, capacity, D).transpose(0, 1)

    (out,) = rowwise(_combine, (*route, y), like=x, lo=0, hi=E, n_experts=E, top_k=top_k)
    return shard(out, "batch", "seq", None), shard(probs, "batch", "seq", None)


def _route(x: torch.Tensor, router: torch.Tensor, *, top_k: int, capacity: int):
    """Route each row: (probs, and the sorted pairs' expert, slot, keep,
    weight and order)."""
    B, S, D = x.shape
    E = router.shape[1]
    dev = x.device
    logits = einsum("bsd,de->bse", x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)  # (B, S, E)
    w, idx = _top_k(probs, top_k)  # (B, S, k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)

    SK = S * top_k
    e_flat = idx.reshape(B, SK)  # token-major a row
    order = torch.argsort(e_flat, dim=1, stable=True)
    e_s = torch.gather(e_flat, 1, order)
    w_s = torch.gather(w.reshape(B, SK), 1, order)

    counts = torch.zeros((B, E), dtype=torch.long, device=dev)
    counts.scatter_add_(1, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(SK, device=dev)[None] - torch.gather(starts, 1, e_s)
    keep = pos < capacity
    return probs, e_s, pos, keep, w_s, order


def _dispatch(x: torch.Tensor, router: torch.Tensor, *, top_k: int, capacity: int):
    """Route each row: (probs, the (B, E, capacity + 1, D) expert buffer,
    and the sorted pairs' expert, slot, keep, weight and order)."""
    E = router.shape[1]
    probs, *route = _route(x, router, top_k=top_k, capacity=capacity)
    (buf,) = _slots(x, *route, lo=0, hi=E, n_experts=E, top_k=top_k, capacity=capacity)
    return probs, buf, *route


def _mine(e_s, keep, lo: int, hi: int, n_experts: int):
    """The pairs kept in the experts lo..hi-1, and their index there."""
    if lo == 0 and hi == n_experts:
        return keep, e_s
    mine = keep & (e_s >= lo) & (e_s < hi)
    return mine, torch.where(mine, e_s - lo, 0)


def _slots(x, e_s, pos, keep, w_s, order, *, lo: int, hi: int, n_experts: int, top_k: int,
           capacity: int):
    """The (B, hi - lo, capacity + 1, D) buffer of the experts lo..hi-1:
    each row's pairs kept there in their slots, the rest written (as
    zeros) to the sacrificial last slot."""
    B, _, D = x.shape
    mine, e_mine = _mine(e_s, keep, lo, hi, n_experts)
    pos_c = torch.where(mine, pos, capacity)
    b_idx = torch.arange(B, device=x.device)[:, None]
    x_sorted = _TokenRows.apply(x, order // top_k)
    buf = torch.zeros((B, hi - lo, capacity + 1, D), dtype=x.dtype, device=x.device)
    buf[b_idx, e_mine, pos_c] = x_sorted * mine[..., None].to(x.dtype)
    return (buf,)


class _TokenRows(torch.autograd.Function):
    """``x[b, t[b, p]]``: each pair's token row, read by ``torch.gather``.
    A token is read ``top_k`` times, so its gradient sums ``top_k`` rows:
    ``gather``'s own backward adds them with atomics, in whatever order
    they land on the card, and a restart would not repeat the run bit for
    bit.  This backward adds them through ``index_put_(accumulate=True)``
    (an index's backward), whose CUDA kernel sorts the indices and sums
    each token's rows in one order."""

    @staticmethod
    def forward(ctx, x, t):
        ctx.save_for_backward(t)
        ctx.x_shape = x.shape
        return torch.gather(x, 1, t[..., None].expand(*t.shape, x.shape[-1]))

    @staticmethod
    def backward(ctx, grad):
        (t,) = ctx.saved_tensors
        b = torch.arange(t.shape[0], device=t.device)[:, None].expand_as(t)
        return grad.new_zeros(ctx.x_shape).index_put_((b, t), grad, accumulate=True), None


def _combine(e_s, pos, keep, w_s, order, y, *, lo: int, hi: int, n_experts: int, top_k: int):
    """The outputs (B, hi - lo, capacity, D) of the experts lo..hi-1 back
    to the pairs (a pair dropped or of another expert reads slot 0 and is
    zeroed), then to token-major order, and each token's k outputs summed:
    (B, S, D)."""
    B, SK = e_s.shape
    D = y.shape[-1]
    mine, e_mine = _mine(e_s, keep, lo, hi, n_experts)
    b_idx = torch.arange(B, device=y.device)[:, None]
    y_pair = y[b_idx, e_mine, torch.where(mine, pos, 0)] * (mine * w_s)[..., None].to(y.dtype)
    y_tok = torch.empty_like(y_pair).scatter_(1, order[..., None].expand(B, SK, D), y_pair)
    return (y_tok.reshape(B, SK // top_k, top_k, D).sum(dim=2),)


# ---------------------------------------------------------------------------
# Dropless MoE (DeepSeek-V3's router): every routed pair runs
# ---------------------------------------------------------------------------

# Token rows a chunk of ``dropless_moe`` times its experts: 65536 rows of
# (E, rows, F) and (E, rows, D) temporaries (~0.75 GB at Moonlight's widths).
_DROPLESS_ROWS = 65536


def route_topk(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor | None, *, top_k: int,
               scoring: str, norm_topk: bool, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Each token's experts and weights, in float32: x (N, D) -> (idx (N, k),
    w (N, k)).  s = softmax or sigmoid of x @ router; the top k by s + bias
    (``bias`` None: by s), largest first, ties to the lower expert
    (``_top_k``); their weights the chosen s without the bias, normalised
    to sum 1 under ``norm_topk`` (DeepSeek-V3's + 1e-20 in the sum), times
    ``scale`` (``routed_scaling_factor``)."""
    logits = x.float() @ router.float()
    s = torch.sigmoid(logits) if scoring == "sigmoid" else torch.softmax(logits, dim=-1)
    _, idx = _top_k(s if bias is None else s + bias.float(), top_k)
    w = torch.gather(s, -1, idx)
    if norm_topk:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * scale


def dropless_moe(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The routed experts' sum for tokens x (N, D) routed to ``idx`` with
    weights ``w`` (N, k): out[n] = sum_j w[n, j] * expert_idx[n, j](x[n]),
    each expert a SwiGLU of (E, D, F) / (E, F, D) weights.  Nothing is
    dropped: every expert runs over every token of a chunk (``bmm`` on the
    token rows, broadcast over the experts, not copied) and its output
    enters with the token's weight for it, zero where the token did not
    choose it; the weights are in x's type, and the combine sums the E
    outputs in float32 inside one batched product a token.  That is E / k
    times the routed pairs' FLOPs (64 / 6 at Moonlight's widths), the
    baseline a grouped dispatch improves on; at one token a row (decode)
    the experts' weights are read once a step either way.  Tokens run in
    chunks of ``_DROPLESS_ROWS // E`` rows, which bounds the temporaries."""
    N, D = x.shape
    E = w_gate.shape[0]
    dt = x.dtype
    dense_w = torch.zeros((N, E), dtype=torch.float32, device=x.device).scatter_(1, idx, w)
    dense_w = dense_w.to(dt)
    out = torch.empty_like(x)
    step = max(1, _DROPLESS_ROWS // E)
    for a in range(0, N, step):
        b = min(N, a + step)
        xe = x[a:b].expand(E, b - a, D)
        g = torch.bmm(xe, w_gate.to(dt))
        u = torch.bmm(xe, w_up.to(dt))
        y = torch.bmm(F.silu(g.float()).to(dt) * u, w_down.to(dt))  # (E, n, D)
        out[a:b] = torch.bmm(dense_w[a:b, None, :], y.transpose(0, 1))[:, 0]
    return out


def moe_aux_loss(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """Switch-style load-balance loss over all routed tokens.

    probs: (..., E) router softmax.  loss = E * sum(frac_tokens_e * mean_prob_e),
    the fractions from the top-k hard assignment.
    """
    E = probs.shape[-1]
    flat = reshape(probs, probs.numel() // E, E)
    (hard,) = rowwise(_hard_top_k, (flat,), top_k=top_k)
    frac = mean(hard, 0) / top_k
    mean_prob = mean(flat, 0)
    return E * torch.sum(frac * mean_prob)


def _hard_top_k(flat: torch.Tensor, *, top_k: int) -> tuple[torch.Tensor]:
    """Each row's top-k assignment as 0 / 1."""
    _, idx = _top_k(flat, top_k)
    return (torch.zeros_like(flat).scatter_(1, idx, 1.0),)
