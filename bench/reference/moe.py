"""Plain float32 reference of the MoE transformer: the dense reference
(``transformer.py``, beside this file) with a routed mixture of experts in
place of the MLP, as the program defines its ``moe`` family.

Each batch row's prompt routes as one group, and each decoded position as
a group of its own (the program's prefill routes a row's prompt together,
its decode step one position a row). In a group: float32 router logits and
softmax, the top k (largest first, ties to the lower expert), their weights
renormalised to sum 1; each expert keeps the first
``ceil(group * k / E * capacity)`` of the group's tokens that chose it, in
token order, and drops the rest (a dropped pair adds nothing). A kept pair
adds its weight times the expert's SwiGLU of the token. The router stays
in float32 under ``quant``.
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


def route(hn: torch.Tensor, router: torch.Tensor, top_k: int, capacity_factor: float,
          prompt: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(experts (R, N, k), weights (R, N, k), kept (R, N, k)) of each token:
    positions below ``prompt`` route as one group a row, the rest alone."""
    R, N, _ = hn.shape
    E = router.shape[-1]
    probs = torch.softmax(hn @ router.float(), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :top_k], idx[..., :top_k]
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    kept = torch.ones_like(idx, dtype=torch.bool)
    P = min(prompt, N)
    cap = max(1, math.ceil(P * top_k / E * capacity_factor))
    chose = torch.zeros((R, P, E), device=hn.device).scatter_(2, idx[:, :P], 1.0)
    before = torch.cumsum(chose, dim=1) - chose  # earlier tokens of the group that chose e
    kept[:, :P] = torch.gather(before, 2, idx[:, :P]) < cap
    # a decoded position alone: its k experts are distinct and each keeps at
    # least one pair, so nothing drops there
    return idx, w, kept


def experts(hn: torch.Tensor, p: dict, inputs: dict, a: dict, quant=None) -> torch.Tensor:
    m = p["moe"]
    spec = a["moe"]
    idx, w, kept = route(hn, m["router"], spec["top_k"], spec["capacity"], inputs["prompt"])
    out = torch.zeros_like(hn)
    for e in range(m["router"].shape[-1]):
        sel = (idx == e) & kept  # (R, N, k): at most one slot a token
        rows = sel.any(-1)
        if not bool(rows.any()):
            continue
        x = hn[rows]
        g = dense.product("nd,df->nf", x, m["w_gate"][e], quant)
        u = dense.product("nd,df->nf", x, m["w_up"][e], quant)
        y = dense.product("nf,fd->nd", F.silu(g) * u, m["w_down"][e], quant)
        out[rows] += (w * sel).sum(-1)[rows][:, None] * y
    return out


def logits(a: dict, weights: dict, inputs: dict, *, out_start: int, quant=None) -> torch.Tensor:
    """The MoE model's logits (see ``transformer.forward``)."""

    def ffn(hn, p, inp, q):
        return experts(hn, p, inp, a, q)

    with dense.exact_float32(), torch.no_grad():
        return dense.forward(a, weights, inputs, out_start=out_start, ffn=ffn, quant=quant)
