"""The plain references against the program at CPU sizes, in float32: the
program's prefill, then its decode steps through the cache grown to
``max_len``, against the reference's full forward over the prompt and the
fed tokens. A MoE whose capacity drops tokens and one that drops none; a
VLM with a patch prefix and 3-D positions; a dense model."""

from __future__ import annotations

import pytest
import torch

import tiny
from common import load_module
from traffic import Traffic
from weights import draw

COUNTS = load_module(tiny.BENCH / "counts" / "transformer.py")
SERVE = load_module(tiny.BENCH / "runners" / "serve.py")


def _case(base: str, **as_run):
    return {**tiny.CONFIGS[base], "as_run": {**tiny.CONFIGS[base]["as_run"], **as_run}}


CASES = {
    "moe": (_case("tiny-moe", dtype="float32"), "tiny-text"),
    "moe-nodrop": (_case("tiny-moe", dtype="float32",
                         moe={"n_experts": 8, "top_k": 3, "capacity": 8 / 3}), "tiny-text"),
    "vlm": (_case("tiny-vlm", dtype="float32"), "tiny-image"),
    "dense": (_case("tiny-vlm", dtype="float32", name="tiny-dense", family="dense",
                    rope="rope", modality="text", qkv_bias=False, tie_embeddings=False),
              "tiny-text"),
}


def _program_logits(cfg: dict, weights: dict, batch: dict, traffic: Traffic) -> tuple:
    """The program's logits at the prompt's last position and each decode
    step, and the greedy tokens it fed."""
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    model = Model(SERVE.model_config(cfg["as_run"]), params=weights, device="cpu")
    engine = ServeEngine(model, ServeConfig(max_len=traffic.max_len), jit=True)
    last, state = engine.prefill(batch)
    out, fed = [last], []
    for i in range(traffic.new - 1):
        tok = torch.argmax(out[-1], dim=-1).to(torch.int32)
        fed.append(tok)
        logits, state = engine.decode(state, tok, traffic.prompt + i)
        out.append(logits)
    return torch.stack(out, dim=1), torch.stack(fed, dim=1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_the_program_through_prefill_and_decode(case):
    cfg, traffic_name = CASES[case]
    a = cfg["as_run"]
    t = Traffic(tiny.TRAFFIC[traffic_name], a, 7, torch.device("cpu"), torch.float32)
    weights = draw(COUNTS.param_shapes(cfg), 7, "cpu", torch.float32)
    batch = t.batch(0)
    got, fed = _program_logits(cfg, weights, batch, t)
    ref = load_module(tiny.BENCH / "reference" / f"{cfg['modules']['reference']}.py")
    inputs = {"tokens": torch.cat([batch["tokens"], fed], dim=1),
              "patch_embeds": batch.get("patch_embeds"),
              "positions": t.served_positions(t.batch_size), "prompt": t.prompt}
    want = ref.logits(a, weights, inputs, out_start=t.prompt - 1)
    assert want.shape == got.shape
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_the_moe_case_drops_tokens_and_the_nodrop_case_none():
    ref = load_module(tiny.BENCH / "reference" / "moe.py")
    for case, drops in (("moe", True), ("moe-nodrop", False)):
        cfg, traffic_name = CASES[case]
        a = cfg["as_run"]
        t = Traffic(tiny.TRAFFIC[traffic_name], a, 7, torch.device("cpu"), torch.float32)
        weights = draw(COUNTS.param_shapes(cfg), 7, "cpu", torch.float32)
        hn = torch.randn(t.batch_size, t.prompt, a["d_model"],
                         generator=torch.Generator().manual_seed(0))
        _, _, kept = ref.route(hn, weights["blocks"]["moe"]["router"][0], a["moe"]["top_k"],
                               a["moe"]["capacity"], t.prompt)
        assert bool((~kept).any()) == drops


def test_vlm_positions_follow_qwen2_vl_and_decode_takes_the_cache_index():
    a = tiny.CONFIGS["tiny-vlm"]["as_run"]
    t = Traffic(tiny.TRAFFIC["tiny-image"], a, 1, torch.device("cpu"), torch.bfloat16)
    pos = t.served_positions(1)[0]
    h, w = t.grid
    assert pos.shape == (t.prompt + t.new - 1, 3)
    assert pos[:h * w, 0].eq(0).all() and pos[w + 1].tolist() == [0, 1, 1]
    assert pos[h * w].tolist() == [max(h, w)] * 3  # the text starts past the image
    assert pos[t.prompt].tolist() == [t.prompt] * 3  # a decoded token: its cache index
