"""The port's spans and counters (``repro_torch.trace``) on the CPU.

Off (the default), a span records nothing and the engine's tokens and the
model's logits are bitwise those of a program without spans; on, a tiny
VLM's ``generate`` records the documented steps and parts in their
documented counts, and the tokens do not change; under ``torch.profiler``
with tracing off the engine's ``serve.*`` ranges lie inside
``serve.generate``; a captured graph's events are read once a replay,
into the step that replayed it, just before that graph replays again;
``snapshot()`` counts the live graphs'
captures and replays and the kernels built from source; the serve
launcher's ``--trace`` prints the spans and counters, ``serve.stop``'s
with ``--eos-id``.
"""

from __future__ import annotations

import contextlib
import os
import stat
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs import get_arch
from repro_torch.kernels import _build
from repro_torch.models import Model
from repro_torch.models import transformer
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve import engine as engine_mod

B, P, T, NEW = 2, 4, 6, 4
BLOCK = ("attn.qkv", "attn.core", "attn.out", "mlp")


@pytest.fixture(autouse=True)
def _clean():
    trace.reset()
    yield
    assert not trace.is_on()
    trace.reset()


def _model(name: str = "qwen2-vl-2b") -> Model:
    cfg = get_arch(name).reduced()
    return Model(cfg, generator=torch.Generator("cpu").manual_seed(0), device=torch.device("cpu"))


def _batch(cfg) -> dict:
    rng = np.random.default_rng(1)
    n_tok = T if cfg.family == "vlm" else P + T
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, n_tok)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((B, P, cfg.d_model)).astype(np.float32))
        batch["positions"] = torch.arange(P + T)[None, :, None].expand(B, P + T, 3).to(torch.int32)
    return batch


@contextlib.contextmanager
def _without_spans(monkeypatch):
    """The program as it was before it had spans: every span a no-op."""
    with monkeypatch.context() as m:
        for mod in (transformer, engine_mod):
            m.setattr(mod.trace, "span", lambda *a, **k: contextlib.nullcontext())
        yield


@pytest.mark.parametrize("name", ["qwen2-vl-2b", "smollm-135m", "moonshot-v1-16b-a3b"])
def test_off_records_nothing_and_changes_no_bit(monkeypatch, name):
    model = _model(name)
    batch = _batch(model.cfg)
    engine = ServeEngine(model, ServeConfig(max_len=P + T + NEW))
    with _without_spans(monkeypatch):
        want_tokens = engine.generate(batch, NEW)
        want_logits = model.forward(batch)
    got_tokens, got_logits = engine.generate(batch, NEW), model.forward(batch)
    assert trace.records() == [] and trace.spans() == {}
    assert torch.equal(got_tokens, want_tokens) and torch.equal(got_logits, want_logits)
    with trace.enabled():
        on_tokens, on_logits = engine.generate(batch, NEW), model.forward(batch)
    assert torch.equal(on_tokens, want_tokens) and torch.equal(on_logits, want_logits)


@pytest.mark.parametrize("eos", [False, True])
def test_on_a_generate_records_each_documented_span_in_its_count(eos):
    model = _model()
    L = model.cfg.n_layers
    # an EOS id no row emits: every step runs the stop check
    engine = ServeEngine(model, ServeConfig(max_len=P + T + NEW,
                                            eos_id=model.cfg.vocab if eos else -1))
    with trace.enabled():
        engine.generate(_batch(model.cfg), NEW)
    recs = trace.records()
    names = [r["name"] for r in recs]
    assert names.count("serve.generate") == 1 and names[-1] == "serve.generate"
    assert names.count("serve.prefill") == 1 and names.count("serve.decode") == NEW - 1
    assert names.count("serve.sample") == NEW
    assert names.count("serve.stop") == (NEW - 1 if eos else 0)
    for rec in recs:
        parts = [n for n, _ in rec["parts"]]
        if rec["name"] in ("serve.prefill", "serve.decode"):
            # one embed, L of each block span in their order, one head
            assert parts == ["embed", *BLOCK * L, "head"]
            assert sum(ms for _, ms in rec["parts"]) <= rec["ms"]
        else:
            assert parts == []
        assert rec["ms"] > 0
    spans = trace.spans()
    assert len(spans["serve.decode/attn.core"]) == NEW - 1  # one number a step, layers summed
    assert spans["serve.decode/attn.core"][0] == pytest.approx(
        sum(ms for n, ms in recs[2]["parts"] if n == "attn.core"))


def test_under_a_profiler_the_engine_ranges_nest_in_generate_with_tracing_off():
    from torch.profiler import ProfilerActivity, profile

    model = _model()
    engine = ServeEngine(model, ServeConfig(max_len=P + T + NEW))
    batch = _batch(model.cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.generate(batch, NEW)
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    (g0, g1), = ranges["serve.generate"]
    assert len(ranges["serve.prefill"]) == 1 and len(ranges["serve.decode"]) == NEW - 1
    assert len(ranges["serve.sample"]) == NEW
    for name in ("serve.prefill", "serve.decode", "serve.sample"):
        assert all(g0 <= a <= b <= g1 for a, b in ranges[name])
    assert not set(BLOCK) & set(ranges)  # the model's spans time only with tracing on
    assert trace.records() == []


class _Event:
    """A stand-in timing event: a clock reading set by the test."""

    def __init__(self, at: float) -> None:
        self.at, self.waits = at, 0

    def synchronize(self) -> None:
        self.waits += 1

    def elapsed_time(self, end: _Event) -> float:
        return end.at - self.at


def test_a_graphs_events_are_read_before_it_replays_again_into_the_step_that_replayed_it():
    a, b, c = _Event(0.0), _Event(2.0), _Event(0.0)
    events = [("attn.core", a, b), ("mlp", b, c)]  # edges shared, as ``after`` gives
    twin = [("attn.core", _Event(0.0), _Event(1.0))]  # the other graph of the signature
    with trace.enabled():
        for step in range(2):
            trace.flush(events)  # as ``CudaGraphStep`` does before a replay
            c.at = 5.0 + 10.0 * step  # the replay records its times
            with trace.span("serve.decode", "cpu", outer=True):
                trace.replayed(events)
            with trace.span("serve.decode", "cpu", outer=True):
                waits = c.waits
                trace.flush(twin)  # reads the twin's alone: no wait for ``events``
                assert c.waits == waits
                trace.replayed(twin)
        trace.flush(events)
        c.at = 25.0
        trace.replayed(events)  # outside any step: records of their own
    recs = trace.records()
    assert [r["name"] for r in recs] == ["serve.decode"] * 4 + ["attn.core", "mlp"]
    assert recs[0]["parts"] == [("attn.core", 2.0), ("mlp", 3.0)]
    assert recs[1]["parts"] == [("attn.core", 1.0)]
    assert recs[2]["parts"] == [("attn.core", 2.0), ("mlp", 13.0)]
    assert [r["ms"] for r in recs[4:]] == [2.0, 23.0]
    assert trace.spans()["serve.decode/mlp"] == [3.0, 13.0]


def test_a_span_after_another_starts_where_it_ended():
    with trace.enabled():
        with trace.span("serve.decode", "cpu", outer=True):
            with trace.span("attn.qkv", "cpu") as first:
                pass
            with trace.span("attn.core", "cpu", after=first) as second:
                pass
    assert second.start == first.end
    with trace.span("attn.core", "cpu") as off:  # tracing off: nothing to follow
        assert off is None


class _Stand:
    """A stand-in ``CudaGraphStep``: the two records ``snapshot`` reads."""

    def __init__(self, ms: list[float], replays: list[int]) -> None:
        self.captures = [{"signature": i, "ms": m} for i, m in enumerate(ms)]
        self.graphs = {i: type("E", (), {"replays": r})() for i, r in enumerate(replays)}


def test_the_snapshot_counts_the_live_graphs_captures_and_the_kernels_built(monkeypatch, tmp_path):
    before = trace.snapshot()
    steps = [_Stand([10.0, 2.5], [3, 4]), _Stand([1.0], [7])]
    for s in steps:
        trace.watch(s)
    got = trace.snapshot()
    assert got["graph.captures"] - before["graph.captures"] == 3
    assert got["graph.capture_ms"] - before["graph.capture_ms"] == pytest.approx(13.5)
    assert got["graph.replays"] - before["graph.replays"] == 14
    del steps, s
    assert trace.snapshot()["graph.captures"] == before["graph.captures"]  # only the live ones

    # a stand-in nvcc: writes the library it is asked for
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        open(sys.argv[sys.argv.index("-o") + 1], "w").write("")
        """))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "build")
    built = trace.snapshot().get("kernels.builds.rglru_scan", 0)
    _build._build("rglru_scan")
    _build._build("rglru_scan")  # found in the cache: not built again
    got = trace.snapshot()
    assert got["kernels.builds.rglru_scan"] - built == 1
    assert got["kernels.build_s"] > 0
    assert os.path.exists(_build._library("rglru_scan"))


@pytest.mark.parametrize("eos", [False, True])
def test_the_serve_launcher_prints_the_spans_and_counters_with_trace(capsys, eos):
    from repro_torch.launch import serve as serve_cli

    model = _model()
    # with an EOS id every decode step runs the stop check (the rows reach their three tokens)
    assert serve_cli.main(["--arch", "qwen2-vl-2b", "--device", "cpu", "--batch", "2",
                           "--prompt-len", "12", "--new-tokens", "3", "--trace",
                           *(["--eos-id", str(model.cfg.vocab - 1)] if eos else [])]) == 0
    out = capsys.readouterr().out
    assert "counters: graph.capture_ms=0 graph.captures=0 graph.replays=0" in out
    for name in ("serve.generate", "serve.prefill/head", "serve.decode/attn.core", "serve.sample"):
        assert f"span {name}: " in out
    assert "span serve.decode: " in out and " over 2" in out
    assert ("span serve.stop: " in out) == eos  # the stop check, once a decode step
