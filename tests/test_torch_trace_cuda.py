"""The port's spans inside captured serving steps, on the card (``needs_cuda``;
no JAX).

qwen2-vl-2b at its published widths, cut to a few layers, in bf16 through
``ServeEngine(jit=True)``: with tracing off the captured graphs hold the
kernel nodes of a program without spans and no event node; with tracing
on a signature is captured again, twice, beside the untraced one
(timing-event nodes, the same kernel nodes, no second warm-up, under
1 GiB more reserved) and gives the untraced graphs' tokens bit for bit; a traced
decode step's spans each take time and together cover at least 95% of its
``serve.decode`` span.  A step without spans of its own (the train loop's
whole-step graph, a state-space model's serving steps) keeps one graph a
signature with tracing on, with no event node.  The block's split into
spans frees the attention's temporaries where the unsplit block did: a
captured prefill's pool grows no more than the unsplit block's, and less
than the split's would without its frees.

    PYTHONPATH=src python -m pytest -q -m needs_cuda tests/test_torch_trace_cuda.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import re
import tempfile
import warnings

import pytest
import torch

from repro_torch import trace
from repro_torch.configs import get_arch
from repro_torch.configs.shapes import InputShape
from repro_torch.data import make_batch_fn
from repro_torch.models import ExecConfig, Model
from repro_torch.models import transformer
from repro_torch.optim import AdamW, linear_warmup_cosine
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve import engine as engine_mod
from repro_torch.graphs import signature
from repro_torch.train import TrainLoop, TrainLoopConfig

pytestmark = pytest.mark.needs_cuda

LAYERS, B, GRID, TEXT, NEW, MAX_LEN = 6, 64, 8, 192, 6, 1024
BLOCK = ("attn.qkv", "attn.core", "attn.out", "mlp")


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(get_arch("qwen2-vl-2b"), n_layers=LAYERS)
    dev = torch.device("cuda", 0)
    return Model(cfg, generator=torch.Generator(dev).manual_seed(3), device=dev,
                 dtype=torch.bfloat16)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _clean():
    trace.reset()
    yield
    trace.reset()


def _batch(cfg, seed: int) -> dict:
    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(seed)
    n = GRID * GRID
    r, c = (torch.arange(n, device=dev) // GRID, torch.arange(n, device=dev) % GRID)
    pos = torch.cat([torch.stack([torch.zeros_like(r), r, c], -1),
                     (GRID + torch.arange(TEXT, device=dev))[:, None].expand(TEXT, 3)])
    return {"tokens": torch.randint(0, cfg.vocab, (B, TEXT), generator=g, device=dev,
                                    dtype=torch.int32),
            "patch_embeds": torch.randn(B, n, cfg.d_model, generator=g, device=dev,
                                        dtype=torch.bfloat16),
            "positions": pos[None].expand(B, -1, -1).to(torch.int32).contiguous()}


def _engine(model) -> ServeEngine:
    return ServeEngine(model, ServeConfig(max_len=MAX_LEN))


def _kernels(step, key) -> list[str]:
    """The graph's kernel nodes by name, in order (their IDs left out)."""
    return [re.sub(r"^\| \{ID \| \d+ (\(topoId: \d+\) )?\| ", "", k) for k in step.kernels(key)]


def _event_nodes(step, key) -> int:
    """How many nodes of the graph record an event, as
    ``cudaGraphDebugDotPrint`` prints them."""
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        path = os.path.join(tmp, "graph.dot")
        step.graphs[key].graph.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    return dot.count("\nEVENT_RECORD\n")  # a line of the node's label


def test_untraced_graphs_hold_the_kernels_of_a_program_without_spans(model, monkeypatch):
    batch = _batch(model.cfg, 1)
    engine = _engine(model)
    engine.generate(batch, 3)
    with monkeypatch.context() as m:
        for mod in (transformer, engine_mod):
            m.setattr(mod.trace, "span", lambda *a, **k: contextlib.nullcontext())
        plain = _engine(model)
        plain.generate(batch, 3)
    for step, other in ((engine._prefill, plain._prefill), (engine._decode, plain._decode)):
        (key,), (other_key,) = step.graphs, other.graphs
        assert key == other_key
        assert _kernels(step, key) == _kernels(other, other_key)
        assert _event_nodes(step, key) == 0
        assert step.graphs[key].events == []


def test_a_traced_capture_beside_the_untraced_gives_its_tokens_bit_for_bit(model):
    batch = _batch(model.cfg, 2)
    engine = _engine(model)
    want = engine.generate(batch, NEW)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    with trace.enabled():
        got = engine.generate(batch, NEW)  # captures both steps again, traced
        again = engine.generate(batch, NEW)  # replays them
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)
    assert torch.cuda.memory_reserved() - reserved < 2**30  # into the same pool
    assert torch.equal(engine.generate(batch, NEW), want)  # the untraced graphs, untouched
    for step in (engine._prefill, engine._decode):
        (plain,) = [k for k in step.graphs if k[1] != "traced"]
        traced = [(plain, "traced", 0), (plain, "traced", 1)]  # replayed in turns
        assert set(step.graphs) == {plain, *traced} and len(step.captures) == 3
        for key in traced:
            assert _kernels(step, key) == _kernels(step, plain)
            assert len(step.graphs[key].events) == 2 + 4 * LAYERS  # embed, blocks, head
            # a pair for embed and for head, five a block: its four spans share edges
            assert _event_nodes(step, key) == 4 + 5 * LAYERS
    assert signature((batch,)) in engine._prefill.graphs


def test_a_traced_decode_steps_spans_cover_its_serve_decode_span(model):
    batch = _batch(model.cfg, 3)
    engine = _engine(model)
    engine.generate(batch, 2)
    with trace.enabled():
        engine.generate(batch, 3)  # the traced captures: a prefill, both decode graphs
        engine.generate(batch, 3)  # the second prefill graph
        trace.reset()
        engine.generate(batch, NEW)
    recs = [r for r in trace.records() if r["name"] == "serve.decode"]
    assert len(recs) == NEW - 1
    for rec in recs:
        parts = [n for n, _ in rec["parts"]]
        assert parts == ["embed", *BLOCK * LAYERS, "head"]
        assert all(ms > 0 for _, ms in rec["parts"])
        covered = sum(ms for _, ms in rec["parts"])
        assert 0.95 * rec["ms"] <= covered <= rec["ms"], (covered, rec["ms"])
    prefill, = [r for r in trace.records() if r["name"] == "serve.prefill"]
    assert [n for n, _ in prefill["parts"]] == ["embed", *BLOCK * LAYERS, "head"]
    assert sum(ms for _, ms in prefill["parts"]) <= prefill["ms"]


@pytest.mark.parametrize("what", ["train", "ssm-serve"])
def test_a_step_without_spans_keeps_one_graph_a_signature_with_tracing_on(dev, what):
    if what == "train":  # its forward holds the block spans, which time nothing here
        cfg = get_arch("smollm-135m").reduced()
        m = Model(cfg, ExecConfig(attn_impl="xla", remat="full"), params={}, device=dev)
        loop = TrainLoop(m, AdamW(linear_warmup_cosine(1e-3, 1, 10)),
                         make_batch_fn(cfg, InputShape("t", 32, 4, "train"), seed=1),
                         TrainLoopConfig(total_steps=3, ckpt_every=3, log_every=0),
                         jit=True, donate=True)
        with trace.enabled():
            loop.run(torch.Generator(dev).manual_seed(0))
        steps = [loop.step_fn]
    else:
        cfg = get_arch("mamba2-130m").reduced()
        m = Model(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
        engine = ServeEngine(m, ServeConfig(max_len=32))
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), device=dev, dtype=torch.int32)}
        with trace.enabled():
            engine.generate(batch, 4)
            engine.generate(batch, 4)
        steps = [engine._prefill, engine._decode]
    for step in steps:
        (key,) = step.graphs
        assert key == step.captures[0]["signature"] and len(step.captures) == 1
        assert step.graphs[key].replays > 0 and step.graphs[key].events == []
        assert _event_nodes(step, key) == 0


def _unsplit_block(cfg, ex, p, h, pos, *, cache, cache_idx):
    """The block before spans split it (a dense or vlm block): q, k, v and
    the attention's output die when the attention returns."""

    def attention(hn):
        q, k, v = transformer._qkv(cfg, ex, p["attn"], hn, pos, cached=cache is not None)
        out, new_cache = transformer._attend(ex, q, k, v, cache=cache, cache_idx=cache_idx)
        return transformer.einsum("bshk,hkd->bsd", out, p["attn"]["wo"].to(hn.dtype)), new_cache

    h = transformer.shard(h, "batch", "act_seq", None)
    hn = transformer.rms_norm(h, p["ln1"], cfg.norm_eps)
    attn_out, new_cache = attention(hn)
    h = h + attn_out
    h = transformer.shard(h, "batch", "act_seq", None)
    hn2 = transformer.rms_norm(h, p["ln2"], cfg.norm_eps)
    m = p["mlp"]
    y = transformer.swiglu(hn2, m["w_gate"], m["w_up"], m["w_down"])
    return transformer.shard(h + y, "batch", "act_seq", None), None, new_cache


def _kept_to_the_next_layer(attend):
    """``_attend`` whose q and output live on to the next layer's attention,
    as a split block's would without its frees."""
    held = []

    def kept(ex, q, k, v, **kw):
        out, cache = attend(ex, q, k, v, **kw)
        held[:] = [q, out]
        return out, cache

    return kept


def test_a_captured_prefills_pool_grows_no_more_than_the_unsplit_blocks(dev, monkeypatch):
    # a small vocabulary, so that the head's logits do not hide the blocks' memory
    cfg = dataclasses.replace(get_arch("qwen2-vl-2b"), n_layers=LAYERS, vocab=1024)
    small = Model(cfg, generator=torch.Generator(dev).manual_seed(4), device=dev,
                  dtype=torch.bfloat16)
    batch = _batch(cfg, 4)

    def growth() -> int:
        """Bytes reserved by a fresh engine's first prefill (warm-up and capture)."""
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_reserved()
        engine = _engine(small)
        engine.prefill(batch)
        torch.cuda.synchronize()
        grown = torch.cuda.max_memory_reserved() - before
        del engine
        return grown

    split = growth()
    with monkeypatch.context() as m:
        m.setattr(transformer, "_block_apply", _unsplit_block)
        unsplit = growth()
    with monkeypatch.context() as m:
        m.setattr(transformer, "_attend", _kept_to_the_next_layer(transformer._attend))
        unfreed = growth()
    assert split <= unsplit < unfreed, (split, unsplit, unfreed)
