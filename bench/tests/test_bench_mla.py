"""The latent-attention MoE configuration's benchmark files at CPU sizes: a
tiny MLA-MoE cell (one dense layer, two MoE layers of 8 sigmoid-routed
dropless experts with a shared expert, latent rank 32) added to a tiny
checkout by files alone and run through the harness; its plain reference
against the program through prefill and decode, in float32; its counts by
hand and its tree against the program's; the latent roofline reader on a
made-up trace."""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest
import torch

import tiny
from common import Cell, load_module
from traffic import Traffic
from weights import draw

COUNTS = load_module(tiny.BENCH / "counts" / "mla_moe.py")
REF = load_module(tiny.BENCH / "reference" / "mla_moe.py")
SERVE = load_module(tiny.BENCH / "runners" / "serve.py")
ROOFLINE = load_module(tiny.BENCH / "metrics" / "mla_roofline.gen.py")

AS_RUN = {"name": "tiny-mla", "family": "moe", "n_layers": 3, "d_model": 64, "n_heads": 4,
          "n_kv_heads": 4, "d_ff": 24, "vocab": 256, "norm_eps": 1e-5, "dtype": "float32",
          "moe": {"n_experts": 8, "top_k": 3, "n_shared": 1, "scoring": "sigmoid",
                  "correction_bias": True, "norm_topk": True, "routed_scale": 2.446,
                  "dropless": True},
          "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
          "first_dense_layers": 1, "dense_d_ff": 96, "rope": "rope", "rope_theta": 50000.0,
          "tie_embeddings": False}
CONFIG = {"as_run": AS_RUN, "modules": {"counts": "mla_moe", "reference": "mla_moe"}}
TRAFFIC = {"runner": "serve", "batch": 3, "text_tokens": 12, "image_grid": None, "new_tokens": 5}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape if hasattr(v, "shape") else v[0])
    return out


def test_the_weight_tree_is_the_programs():
    from repro_torch.models import transformer

    want = _flat(transformer.lm_specs(SERVE.model_config(AS_RUN)))
    assert _flat(COUNTS.param_shapes(CONFIG)) == want


def test_the_reference_matches_the_program_through_prefill_and_decode():
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    t = Traffic(TRAFFIC, AS_RUN, 7, torch.device("cpu"), torch.float32)
    weights = draw(COUNTS.param_shapes(CONFIG), 7, "cpu", torch.float32)
    batch = t.batch(0)
    model = Model(SERVE.model_config(AS_RUN), params=weights, device="cpu")
    engine = ServeEngine(model, ServeConfig(max_len=t.max_len), jit=True)
    last, state = engine.prefill(batch)
    out, fed = [last], []
    for i in range(t.new - 1):
        tok = torch.argmax(out[-1], dim=-1).to(torch.int32)
        fed.append(tok)
        logits, state = engine.decode(state, tok, t.prompt + i)
        out.append(logits)
    inputs = {"tokens": torch.cat([batch["tokens"], torch.stack(fed, dim=1)], dim=1),
              "positions": t.served_positions(t.batch_size), "prompt": t.prompt}
    want = REF.logits(AS_RUN, weights, inputs, out_start=t.prompt - 1)
    torch.testing.assert_close(torch.stack(out, dim=1), want, atol=1e-4, rtol=1e-4)


def test_a_tiny_mla_cell_runs_through_the_harness(checkout):
    """Added by files alone: its configuration, traffic, cell and entry."""
    bench = checkout / "bench"
    (bench / "configs" / "tiny-mla.json").write_text(json.dumps(CONFIG))
    (bench / "traffic" / "tiny-chat.json").write_text(json.dumps(TRAFFIC))
    (bench / "cells" / "tiny-mla.chat.json").write_text(json.dumps(
        {"sample_requests": 3, "reference_rows": 2, "limits": {"max_gap": {"at_most": 1e-3}}}))
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-mla", "source": "test", "file": "bench/configs/tiny-mla.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-mla.chat", "config": "tiny-mla",
                              "traffic": "tiny-chat", "chips": 1, "why": "test"})
    (checkout / "BENCHMARK.json").write_text(json.dumps(spec))
    run = load_module(tiny.BENCH / "run.py")
    result, notes = run.execute(Cell(checkout, "tiny-mla.chat"), seed=2**33 + 5, seconds=0.3,
                                trace=False, device="cpu", t_start=time.perf_counter())
    assert result["correct"] and result["attempted"] > 0
    assert {"setup_s", "request_p95_ms"} <= set(result["metrics"])
    assert notes["tokens_compared"] == 3 * TRAFFIC["new_tokens"]


def test_call_flops_and_the_latent_launch_by_hand():
    # per token: q 64*4*24, kv_a 64*40, k_b + v_b 32*4*32, o 4*16*64
    attn = 64 * 4 * 24 + 64 * 40 + 32 * 4 * 32 + 4 * 16 * 64
    dense = 2 * (attn + 3 * 64 * 96)
    moe = 2 * (attn + 64 * 8 + (3 + 1) * 3 * 64 * 24)  # router, top-3 and the shared expert
    B, P, new = 2, 5, 3
    pairs = 15 + 6 + 7
    want = B * ((dense + 2 * moe) * 7 + 3 * 2 * 4 * (24 + 16) * pairs + 2 * 64 * 256 * new)
    assert COUNTS.call_flops(AS_RUN, B, P, new) == want
    ops, n_bytes = COUNTS.mla_decode_launch({**AS_RUN, "dtype": "bfloat16"}, 2, 10)
    assert ops == 2 * 2 * 4 * 10 * (32 + 8 + 32)
    assert n_bytes == 2 * 2 * (10 * 40 + 4 * 40 + 4 * 32)


def test_the_published_tree_has_the_published_count():
    import math

    config = json.loads((tiny.ROOT / "bench" / "configs" / "moonlight-16b-a3b.json").read_text())

    def count(tree):
        return sum(count(v) if isinstance(v, dict) else math.prod(v[0]) for v in tree.values())

    assert count(COUNTS.param_shapes(config)) == 15_960_110_208


def _run(events, fill=20):
    return SimpleNamespace(__dict__={}, device=torch.device("cuda"),
                           peak={"bf16_flops_s": 989e12, "hbm_bytes_s": 3.35e12},
                           traffic=SimpleNamespace(batch_size=2), counts=COUNTS,
                           as_run={**AS_RUN, "dtype": "bfloat16"}, _events=(fill, events))


@pytest.mark.parametrize("name,picked", [
    ("void (anonymous namespace)::mla_decode_mma_kernel(...)", True),
    ("void (anonymous namespace)::mla_decode_kernel<float>(...)", True),
    ("void (anonymous namespace)::mla_decode_merge_kernel<__nv_bfloat16>(...)", True),
    ("void (anonymous namespace)::decode_attention_kernel<__nv_bfloat16, 128, 6>(...)", False),
    ("nvjet_tst_128x16_64x11_2x1_v_bz_NNT", False),
])
def test_the_latent_kernels_are_picked_by_name(name, picked):
    assert ROOFLINE.is_mla(name) == picked


def test_the_latent_roofline_is_the_bound_over_a_launchs_time(monkeypatch):
    """The launch's split and merge kernels summed, over the layers."""
    ops, n_bytes = COUNTS.mla_decode_launch({**AS_RUN, "dtype": "bfloat16"}, 2, 20)
    bound_ns = max(ops / 989e12, n_bytes / 3.35e12) * 1e9
    events = [("mla_decode_kernel", 0, 100), ("mla_decode_merge_kernel", 100, 120),
              ("nvjet_x", 120, 900), ("mla_decode_kernel", 1000, 1200),
              ("mla_decode_merge_kernel", 1200, 1260), ("mla_decode_kernel", 2000, 2140)]
    run = _run(events)
    monkeypatch.setattr(ROOFLINE, "_measure", lambda r: r._events)
    assert ROOFLINE.read(run) == pytest.approx(100 * bound_ns / (520 / AS_RUN["n_layers"]))
    nothing = _run([("nvjet_x", 0, 100)])
    assert ROOFLINE.read(nothing) is None
    assert ROOFLINE.read(SimpleNamespace(__dict__={}, device=torch.device("cpu"))) is None
