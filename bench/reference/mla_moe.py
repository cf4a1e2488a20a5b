"""Plain float32 reference of latent attention with a DeepSeek MoE, as
Moonlight-16B-A3B publishes it (``model_type`` deepseek_v3; its departures,
which the program shares, in the configuration's ``departures``).

Per layer, x + attn(rms(x)) then x + ffn(rms(x)), RMSNorm scaled by
(1 + scale).  Latent attention (MLA) in the published, expanded form: q =
h W_q, each head's (nope ‖ rope) parts; [c ‖ k_rope] = h W_kv_a, c through
its own RMSNorm; RoPE (half-split) on q's rope part and on k_rope, which
every head shares; each head's k = [c W_k_b ‖ k_rope] and v = c W_v_b;
causal softmax attention scaled by 1 / sqrt(nope + rope); the heads'
outputs through W_o.  The first ``first_dense_layers`` layers run a SwiGLU
MLP ``dense_d_ff`` wide; the rest a MoE: s = sigmoid(h W_r) in float32, the
top k experts by s + the correction bias (largest first, ties to the lower
expert), their weights the chosen s without the bias, normalised to sum 1
(+ 1e-20), times ``routed_scale``; every chosen (token, expert) pair runs,
none is dropped, and adds its weight times the expert's SwiGLU of the
token; the shared experts run on every token as one SwiGLU n_shared *
d_ff wide.  A final RMSNorm and the untied head.

Everything runs in float32 on the weights' device with TF32 off, one layer
at a time (a layer's bf16 weights are widened when it runs), and nothing
of the program is imported: the dense reference's helpers
(``transformer.py``, beside this file) are reused.  ``quant`` (the
control) rounds both operands of every product but the router's to a lower
precision before it runs.
"""

from __future__ import annotations

import math
import sys
from importlib.util import module_from_spec, spec_from_file_location
from pathlib import Path

import torch
import torch.nn.functional as F


def _dense():
    """``transformer.py`` beside this file (the reference is no package)."""
    name = "bench_reference_transformer_py"  # as common.load_module names it
    if name not in sys.modules:
        spec = spec_from_file_location(name, Path(__file__).with_name("transformer.py"))
        sys.modules[name] = module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


dense = _dense()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              block: int = 1024) -> torch.Tensor:
    """Causal softmax attention of q, k (R, N, H, dk) and v (R, N, H, dv),
    each head its own k and v, scores scaled by ``scale``; ``block``
    queries at a time."""
    R, N, H, _ = q.shape
    q, k, v = (q * scale).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out = q.new_empty((R, H, N, v.shape[-1]))
    keys = torch.arange(N, device=q.device)
    for s in range(0, N, block):
        e = min(N, s + block)
        scores = q[:, :, s:e] @ k[:, :, :e].transpose(-1, -2)  # (R, H, b, e)
        mask = keys[None, :e] <= torch.arange(s, e, device=q.device)[:, None]
        scores = scores.masked_fill(~mask, float("-inf"))
        out[:, :, s:e] = torch.softmax(scores, dim=-1) @ v[:, :, :e]
    return out.transpose(1, 2)


def mla(hn: torch.Tensor, at: dict, a: dict, cos: torch.Tensor, sin: torch.Tensor,
        quant=None) -> torch.Tensor:
    """Latent attention of one layer, expanded, with its output product."""
    r, nope = a["kv_lora_rank"], a["qk_nope_head_dim"]
    H = a["n_heads"]
    product = dense.product
    q = product("rnd,dhk->rnhk", hn, at["wq"], quant)
    kv = product("rnd,dk->rnk", hn, at["wkv_a"], quant)
    c = dense.rms_norm(kv[..., :r], at["kv_norm"], a["norm_eps"])
    k_rope = dense.rotate(kv[:, :, None, r:], cos, sin)  # (R, N, 1, rope)
    k = torch.cat([product("rnc,chk->rnhk", c, at["wk_b"], quant),
                   k_rope.expand(-1, -1, H, -1)], dim=-1)
    v = product("rnc,chk->rnhk", c, at["wv_b"], quant)
    q = torch.cat([q[..., :nope], dense.rotate(q[..., nope:], cos, sin)], dim=-1)
    o = attention(q, k, v, 1.0 / math.sqrt(q.shape[-1]))
    return product("rnhk,hkd->rnd", o, at["wo"], quant)


def route(hn: torch.Tensor, m: dict, spec: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(experts (R, N, k), weights (R, N, k)) of each token, in float32."""
    logits = hn @ m["router"].float()
    s = torch.sigmoid(logits) if spec["scoring"] == "sigmoid" else torch.softmax(logits, -1)
    choice = s + m["bias"].float() if "bias" in m else s
    idx = torch.sort(choice, dim=-1, descending=True, stable=True).indices[..., : spec["top_k"]]
    w = torch.gather(s, -1, idx)
    if spec.get("norm_topk", True):
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * spec.get("routed_scale", 1.0)


def moe(hn: torch.Tensor, m: dict, a: dict, quant=None) -> torch.Tensor:
    """The routed experts' weighted sum (every pair runs) and the shared
    experts'."""
    idx, w = route(hn, m, a["moe"])
    out = torch.zeros_like(hn)
    for e in range(m["router"].shape[-1]):
        sel = idx == e  # (R, N, k): at most one slot a token
        rows = sel.any(-1)
        if not bool(rows.any()):
            continue
        x = hn[rows]
        g = dense.product("nd,df->nf", x, m["w_gate"][e], quant)
        u = dense.product("nd,df->nf", x, m["w_up"][e], quant)
        y = dense.product("nf,fd->nd", F.silu(g) * u, m["w_down"][e], quant)
        out[rows] += (w * sel).sum(-1)[rows][:, None] * y
    if "shared" in m:
        out = out + dense.mlp(hn, m["shared"], quant)
    return out


def forward(a: dict, weights: dict, inputs: dict, *, out_start: int, quant=None) -> torch.Tensor:
    """float32 logits (R, N - out_start, V) at positions out_start.. of R
    sequences of N positions: ``inputs`` ``tokens`` (R, N) ids and
    ``positions`` (R, N) ids."""
    eps = a["norm_eps"]
    h = weights["embed"][inputs["tokens"].long()].float()
    cos, sin = dense.rope_tables(inputs["positions"], a["qk_rope_head_dim"], a["rope_theta"], None)
    n_dense = a.get("first_dense_layers", 0)
    stacks = [("dense_blocks", n_dense)] * (n_dense > 0) + [("blocks", a["n_layers"] - n_dense)]
    for key, n in stacks:
        for i in range(n):
            p = dense.layer(i, weights[key])
            h = h + mla(dense.rms_norm(h, p["ln1"], eps), p["attn"], a, cos, sin, quant)
            hn = dense.rms_norm(h, p["ln2"], eps)
            h = h + (dense.mlp(hn, p["mlp"], quant) if "mlp" in p else moe(hn, p["moe"], a, quant))
    h = dense.rms_norm(h[:, out_start:], weights["final_ln"], eps)
    head = weights["embed"].T if a.get("tie_embeddings") else weights["lm_head"]
    return dense.product("rnd,dv->rnv", h, head, quant)


def logits(a: dict, weights: dict, inputs: dict, *, out_start: int, quant=None) -> torch.Tensor:
    """The model's logits (see ``forward``)."""
    with dense.exact_float32(), torch.no_grad():
        return forward(a, weights, inputs, out_start=out_start, quant=quant)
