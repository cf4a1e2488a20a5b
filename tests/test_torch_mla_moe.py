"""Latent attention (MLA) with a DeepSeek MoE (``moonlight-16b-a3b``) on the
CPU, against the benchmark's plain reference (``bench/reference/mla_moe.py``,
imported by its path: plain float32 torch that imports nothing of the
port).

At the reduced twin (one dense layer, two MoE layers of 4 experts top-2
with a shared expert and the correction bias; latent rank 32, nope 16,
rope 8, v 16) on seeded random weights of the benchmark's laws
(``bench/counts/mla_moe.py``): the prefill's logits, then decode steps
through the latent cache at several fills, held to the reference's full
forward at 1e-4 (the float32 products in another order); the absorbed
decode against the expanded form; the latent decode's plain route against
the expanded attention; the router's choice by score + bias, its weights
without the bias, normalised and scaled, ties to the lower expert; no
pair dropped when every token routes to the same experts; the spans and
the per-expert pair tally of a traced ``generate``; the full-width tree's
15,960,110,208 parameters, from meta tensors, in the port, its config and
the benchmark's counts.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch import trace
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels.mla_decode import mla_decode_plain
from repro_torch.models import Model
from repro_torch.models.layers import dropless_moe, route_topk
from repro_torch.serve import ServeConfig, ServeEngine

BENCH = Path(__file__).resolve().parents[1] / "bench"
ARCH = "moonlight-16b-a3b"
TOL = dict(atol=1e-4, rtol=1e-4)
PUBLISHED_PARAMS = 15_960_110_208


def _load(rel: str):
    path = BENCH / rel
    spec = importlib.util.spec_from_file_location("mla_moe_test_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("reference/mla_moe.py")
COUNTS = _load("counts/mla_moe.py")


def _as_run(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _weights(cfg, seed: int = 0) -> dict:
    """Every leaf drawn by the benchmark's laws (norms, bias and all)."""
    gen = torch.Generator().manual_seed(seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else torch.randn(v[0], generator=gen) * v[1]
                for k, v in sorted(node.items())}

    return walk(COUNTS.param_shapes({"as_run": _as_run(cfg)}))


@pytest.fixture(scope="module")
def twin():
    cfg = get_arch(ARCH).reduced()
    weights = _weights(cfg)
    return cfg, weights, Model(cfg, params=weights, device="cpu")


def _tokens(cfg, B: int, N: int, seed: int = 1) -> torch.Tensor:
    return torch.randint(0, cfg.vocab, (B, N), generator=torch.Generator().manual_seed(seed),
                         dtype=torch.int32)


def _ref(cfg, weights, tokens, out_start: int) -> torch.Tensor:
    B, N = tokens.shape
    inputs = {"tokens": tokens, "positions": torch.arange(N).expand(B, N), "prompt": N}
    return REF.logits(_as_run(cfg), weights, inputs, out_start=out_start)


def test_the_reduced_twin_keeps_every_mechanism():
    cfg = get_arch(ARCH).reduced()
    assert cfg.mla and cfg.first_dense_layers == 1 and cfg.n_layers - 1 >= 2
    assert cfg.moe.n_experts >= 4 and cfg.moe.n_shared == 1 and cfg.moe.dropless
    assert (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim) == (32, 16, 8)
    assert cfg.moe.scoring == "sigmoid" and cfg.moe.correction_bias
    assert cfg.param_count() == Model(cfg, device="cpu").n_params()


def test_the_weight_tree_is_the_programs(twin):
    cfg, weights, model = twin

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}

    assert shapes(model.params) == shapes(weights)


def test_prefill_logits_match_the_reference(twin):
    cfg, weights, model = twin
    tokens = _tokens(cfg, 3, 13)
    got = model.forward({"tokens": tokens})
    torch.testing.assert_close(got, _ref(cfg, weights, tokens, 0), **TOL)


@pytest.mark.parametrize("prompt", [1, 6, 11])
def test_prefill_then_decode_through_the_latent_cache_matches_the_full_forward(twin, prompt):
    """The engine's prefill, then its decode steps at fills prompt..prompt+4
    through the (c, rope key) cache grown to max_len, against the
    reference's full forward over the prompt and the fed tokens."""
    cfg, weights, model = twin
    new = 5
    tokens = _tokens(cfg, 2, prompt + new - 1, seed=prompt)
    engine = ServeEngine(model, ServeConfig(max_len=prompt + new + 2))
    last, state = engine.prefill({"tokens": tokens[:, :prompt]})
    c, kr = state
    assert c.shape == (cfg.n_layers, 2, prompt + new + 2, 1, cfg.kv_lora_rank)
    assert kr.shape == (cfg.n_layers, 2, prompt + new + 2, 1, cfg.qk_rope_head_dim)
    got = [last]
    for i in range(prompt, prompt + new - 1):
        logits, state = engine.decode(state, tokens[:, i], i)
        got.append(logits)
    want = _ref(cfg, weights, tokens, prompt - 1)
    torch.testing.assert_close(torch.stack(got, dim=1), want, **TOL)


def test_the_absorbed_decode_equals_the_expanded_form(twin):
    """A decode step (absorbed: the latent query against the cache) against
    the same position of a full forward (expanded: each head's k and v)."""
    cfg, _, model = twin
    tokens = _tokens(cfg, 2, 9, seed=3)
    full = model.forward({"tokens": tokens})
    last, state = model.prefill({"tokens": tokens[:, :4]})
    grown = model.init_state(2, 9)
    for g, s in zip(grown, state, strict=True):
        g[:, :, :4] = s
    for i in range(4, 9):
        logits, grown = model.decode_step(grown, tokens[:, i], torch.tensor(i))
        torch.testing.assert_close(logits, full[:, i], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_the_decode_takes_attn_impls_route_and_refuses_a_bf16_p(twin, monkeypatch, impl):
    """``"pallas"`` decodes through ``ops.mla_decode`` (kernel 7 on the card),
    ``"xla"`` through ``mla_decode_plain`` on any device, as the prefill and
    the other families' decode follow ``attn_impl``; neither rounds p, so
    ``attn_p_dtype="bfloat16"`` raises at a decode step."""
    from repro_torch.models import transformer
    from repro_torch.models.transformer import ExecConfig

    cfg, weights, _ = twin
    calls = []

    def spy(*a, **k):
        calls.append("ops")
        return mla_decode_plain(*a, **k)

    monkeypatch.setattr(transformer.ops, "mla_decode", spy)
    model = Model(cfg, params=weights, device="cpu", ex=ExecConfig(attn_impl=impl))
    tokens = _tokens(cfg, 2, 6, seed=4)
    _, state = model.prefill({"tokens": tokens[:, :5]})
    grown = model.init_state(2, 6)
    for g, s in zip(grown, state, strict=True):
        g[:, :, :5] = s
    logits, _ = model.decode_step(grown, tokens[:, 5], torch.tensor(5))
    assert calls == (["ops"] * cfg.n_layers if impl == "pallas" else [])
    torch.testing.assert_close(logits, model.forward({"tokens": tokens})[:, 5], atol=1e-5,
                               rtol=1e-5)
    bf16_p = Model(cfg, params=weights, device="cpu",
                   ex=ExecConfig(attn_impl=impl, attn_p_dtype="bfloat16"))
    with pytest.raises(NotImplementedError, match="attn_p_dtype"):
        bf16_p.decode_step(grown, tokens[:, 5], torch.tensor(5))


@pytest.mark.parametrize("kv_len", [1, 5, 12, 40])
def test_the_latent_decodes_plain_route_is_expanded_attention(kv_len):
    """``mla_decode_plain`` (q_lat . c + q_rope . r over the live tokens, the
    latent summed) equals softmax attention over keys [c ‖ r] and values c,
    with an int or a tensor length, a length past T clamped to T."""
    g = torch.Generator().manual_seed(kv_len)
    B, H, T, r, rope = 2, 4, 12, 32, 8
    q = torch.randn(B, H, r + rope, generator=g)
    c = torch.randn(B, T, r, generator=g)
    kr = torch.randn(B, T, rope, generator=g)
    scale = 0.3
    n = min(kv_len, T)
    keys = torch.cat([c, kr], dim=-1)[:, :n]
    p = torch.softmax(torch.einsum("bhw,btw->bht", q * scale, keys), dim=-1)
    want = torch.einsum("bht,btr->bhr", p, c[:, :n])
    for length in (kv_len, torch.tensor(kv_len)):
        torch.testing.assert_close(mla_decode_plain(q, c, kr, kv_len=length, scale=scale), want)
        torch.testing.assert_close(ops.mla_decode(q, c, kr, kv_len=length, scale=scale), want)


def test_routing_bias_selects_and_the_weights_exclude_it():
    """Sigmoid scores; the top 2 by score + bias (the bias lifts expert 3
    over expert 1); weights the chosen scores without it, normalised to 1
    and scaled; a tie goes to the lower expert."""
    x = torch.eye(4)[:2]  # token n reads router row n
    logits = torch.tensor([[2.0, 1.0, 0.0, 0.5], [0.0, 0.0, 0.0, -1e4]])
    bias = torch.tensor([0.0, 0.0, 0.0, 0.5])
    router = torch.cat([logits, torch.zeros(2, 4)])  # (D 4, E 4)
    idx, w = route_topk(x, router, bias, top_k=2, scoring="sigmoid", norm_topk=True, scale=2.5)
    s = torch.sigmoid(logits)
    assert idx[0].tolist() == [3, 0]  # 0.622 + 0.5 over 0.881 over 0.731
    assert idx[1].tolist() == [0, 1]  # four tied at 0.5 (expert 3: 0 + the bias): the lowest two
    want = s[0, [3, 0]] / (s[0, [3, 0]].sum() + 1e-20) * 2.5
    torch.testing.assert_close(w[0], want)
    torch.testing.assert_close(w[1], torch.tensor([1.25, 1.25]))
    idx, w = route_topk(x, router, None, top_k=2, scoring="sigmoid", norm_topk=False, scale=1.0)
    assert idx[0].tolist() == [0, 1]
    torch.testing.assert_close(w[0], s[0, [0, 1]])


def test_no_pair_is_dropped_when_every_token_routes_to_the_same_experts():
    """A bias that sends all 24 tokens to experts 2 and 0: each of them
    takes every token (a capacity of 1.25 x 24 x 2 / 4 would keep 15), and
    the output is each token's weighted sum of its two experts, as the
    reference's per-expert loop gives it."""
    g = torch.Generator().manual_seed(5)
    N, D, E, Fw = 24, 16, 4, 8
    x = torch.randn(N, D, generator=g)
    m = {"router": torch.randn(D, E, generator=g) * 0.01,
         "bias": torch.tensor([5.0, 0.0, 10.0, 0.0]),
         "w_gate": torch.randn(E, D, Fw, generator=g), "w_up": torch.randn(E, D, Fw, generator=g),
         "w_down": torch.randn(E, Fw, D, generator=g)}
    idx, w = route_topk(x, m["router"], m["bias"], top_k=2, scoring="sigmoid", norm_topk=True,
                        scale=2.446)
    assert (idx == torch.tensor([2, 0])).all()
    got = dropless_moe(x, idx, w, m["w_gate"], m["w_up"], m["w_down"])

    def expert(e):
        return (torch.nn.functional.silu(x @ m["w_gate"][e]) * (x @ m["w_up"][e])) @ m["w_down"][e]

    torch.testing.assert_close(got, w[:, :1] * expert(2) + w[:, 1:] * expert(0), **TOL)
    spec = {"top_k": 2, "scoring": "sigmoid", "norm_topk": True, "routed_scale": 2.446}
    want = REF.moe(x[None], m, {"moe": spec})[0]
    torch.testing.assert_close(got, want, **TOL)


def test_dropless_moe_takes_tokens_in_chunks(monkeypatch):
    """Chunks of rows give the same sums as one chunk."""
    from repro_torch.models import layers

    g = torch.Generator().manual_seed(6)
    N, D, E, Fw = 37, 8, 4, 6
    x = torch.randn(N, D, generator=g)
    ws = [torch.randn(E, D, Fw, generator=g), torch.randn(E, D, Fw, generator=g),
          torch.randn(E, Fw, D, generator=g)]
    idx, w = route_topk(x, torch.randn(D, E, generator=g), None, top_k=2, scoring="sigmoid",
                        norm_topk=True, scale=1.0)
    whole = dropless_moe(x, idx, w, *ws)
    monkeypatch.setattr(layers, "_DROPLESS_ROWS", 5 * E)  # 5 tokens a chunk
    torch.testing.assert_close(dropless_moe(x, idx, w, *ws), whole)


def test_a_traced_generate_names_the_moe_parts_and_tallies_the_pairs(twin):
    cfg, _, model = twin
    B, P, new = 2, 5, 4
    engine = ServeEngine(model, ServeConfig(max_len=P + new))
    tokens = _tokens(cfg, B, P)
    trace.reset()
    try:
        with trace.enabled():
            trace.reset()
            out = engine.generate({"tokens": tokens}, new)
            spans = trace.spans()
            snap = trace.snapshot()
    finally:
        trace.reset()
    assert torch.equal(out, engine.generate({"tokens": tokens}, new))  # tracing changes nothing
    n_moe = cfg.n_layers - cfg.first_dense_layers
    for part in ("moe.route", "moe.experts", "moe.shared", "attn.core", "mlp"):
        assert len(spans[f"serve.decode/{part}"]) == new - 1
        assert len(spans[f"serve.prefill/{part}"]) == 1
    pairs = snap["moe.pairs"]
    assert len(pairs) == cfg.moe.n_experts
    # every token of every MoE layer routes top_k pairs: the prompt, then a token a step
    assert sum(pairs) == n_moe * cfg.moe.top_k * B * (P + new - 1)
    assert snap["moe.pairs.max"] == max(pairs)
    assert snap["moe.pairs.mean"] == pytest.approx(sum(pairs) / len(pairs))


def test_the_full_tree_has_the_published_parameter_count():
    """15,960,110,208: the embedding and head, 27 latent attentions, the
    dense layer, 26 MoE layers (router, correction bias, 64 experts, the
    shared experts) and every norm; from the port's meta tensors, its
    config's count and the benchmark's tree."""
    cfg = get_arch(ARCH)
    meta = Model(cfg, params={}, device="cpu").abstract_params()

    def total(tree):
        return sum(total(v) if isinstance(v, dict) else v.numel() for v in tree.values())

    assert total(meta) == cfg.param_count() == PUBLISHED_PARAMS
    import json

    config = json.loads((BENCH / "configs" / f"{ARCH}.json").read_text())

    def count(tree):
        return sum(count(v) if isinstance(v, dict) else math.prod(v[0]) for v in tree.values())

    assert count(COUNTS.param_shapes(config)) == PUBLISHED_PARAMS
    assert config["reduced"] == []


def test_the_latent_kernels_count_as_mla_decode_launches():
    from repro_torch.kernels import counts

    names = ["void (anonymous namespace)::mla_decode_mma_kernel(__nv_bfloat16 const*)",
             "_ZN12_GLOBAL__N_117mla_decode_kernelIfEEvPKT_",
             "void (anonymous namespace)::mla_decode_merge_kernel<float>(float const*)",
             "void (anonymous namespace)::decode_attention_kernel<float, 64, 2>(float const*)"]
    assert counts.seen(names) == {"mla_decode": 2, "decode_attention": 1}
    assert counts.decode_launches(get_arch(ARCH), 3) == {"mla_decode": 81, "rotary": 81}
    assert counts.decode_launches(get_arch("moonshot-v1-16b-a3b"), 3) == {
        "decode_attention": 144, "rotary": 144}


def test_training_and_the_dry_run_refuse_latent_attention():
    from repro_torch.configs.shapes import SHAPES, cell_applicability

    cfg = get_arch(ARCH).reduced()
    model = Model(cfg, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "labels": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="latent attention"):
        model.loss(model.params, batch)
    assert not any(cell_applicability(get_arch(ARCH), s)[0] for s in SHAPES.values())
