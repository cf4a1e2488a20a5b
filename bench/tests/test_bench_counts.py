"""The benchmark's arithmetic against hand counts (one shape per family),
its weight tree against the program's, and the trace reduction on a made-up
trace."""

from __future__ import annotations

import pytest

import tiny
from common import load_module, quantile, reduce_trace

COUNTS = load_module(tiny.BENCH / "counts" / "transformer.py")
SERVE = load_module(tiny.BENCH / "runners" / "serve.py")

# L 2, D 64, H 4, K 2, hd 16, F 96, V 256
ATTN = 64 * 4 * 16 + 2 * 64 * 2 * 16 + 4 * 16 * 64  # q, k, v, o: 12288
PER_TOKEN = {
    "tiny-moe": 2 * (ATTN + 64 * 8 + 3 * 3 * 64 * 96),  # router, top-3 of 8 experts
    "tiny-vlm": 2 * (ATTN + 3 * 64 * 96),
}


@pytest.mark.parametrize("name", sorted(PER_TOKEN))
def test_layer_flops_per_token_by_hand(name):
    assert COUNTS.layer_flops_per_token(tiny.CONFIGS[name]["as_run"]) == PER_TOKEN[name]


@pytest.mark.parametrize("name", sorted(PER_TOKEN))
def test_call_flops_by_hand(name):
    a = tiny.CONFIGS[name]["as_run"]
    B, P, new = 3, 5, 3
    # positions through the layers: 5 prompt + 2 decoded; visible pairs: 15 causal
    # in the prefill, then decode at 5 (6 keys) and 6 (7 keys); 2 layers; the head 3 times
    pairs = 15 + 6 + 7
    want = B * (2 * (PER_TOKEN[name] * 7 + 4 * 4 * 16 * pairs) + 2 * 64 * 256 * new)
    assert COUNTS.call_flops(a, B, P, new) == want


def test_attention_launch_by_hand():
    ops, n_bytes = COUNTS.attention_launch(tiny.CONFIGS["tiny-vlm"]["as_run"], 2, 8)
    assert ops == 4 * 2 * 4 * 16 * 36  # 36 visible pairs at S = 8
    assert n_bytes == 2 * (2 * 2 * 8 * 4 * 16 + 2 * 2 * 8 * 2 * 16)


@pytest.mark.parametrize("name", sorted(tiny.CONFIGS))
def test_weight_tree_is_the_programs(name):
    """The drawn tree has the program's leaves with the program's shapes."""
    from repro_torch.models import transformer

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[prefix + k] = tuple(v.shape if hasattr(v, "shape") else v[0])
        return out

    cfg = tiny.CONFIGS[name]
    want = flat(transformer.lm_specs(SERVE.model_config(cfg["as_run"])))
    assert flat(COUNTS.param_shapes(cfg)) == want


def test_reduce_trace_on_a_made_up_trace():
    dev = [("k1", 10, 20), ("k2", 15, 31), ("k1", 40, 45), ("k3", 90, 200)]
    host = [("outer", 0, 100), ("cudaMemcpyAsync", 30, 41), ("aten::mm", 60, 95)]
    out = reduce_trace(dev, host, 0, 100, top=2)
    assert out["busy_s"] == pytest.approx((21 + 5 + 10) * 1e-9)  # 10-31, 40-45, 90-100
    assert out["window_s"] == pytest.approx(100e-9)
    assert out["device_ops"] == [["k2", pytest.approx(16e-9)], ["k1", pytest.approx(15e-9)]]
    # gaps: 0-10 (outer), 31-40 (cudaMemcpyAsync), 45-90 (outer at 45: aten::mm starts at 60)
    assert out["idle_gaps"] == [["outer", pytest.approx(45e-9)], ["outer", pytest.approx(10e-9)]]


def test_quantile_is_inclusive_linear():
    assert quantile([1.0, 2.0, 3.0, 4.0, 5.0], 0.95) == pytest.approx(4.8)
    assert quantile([7.0], 0.95) == 7.0
