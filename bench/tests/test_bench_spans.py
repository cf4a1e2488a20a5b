"""The readers of the program's own spans: each listed for the cells it reads,
after the metrics that were there; nothing read without a card; and, on
the CPU at a tiny cell's size, the traced work they run gives one number a
step for each span they read."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

import spans
import tiny
from common import Cell, load_module

SERVE = load_module(tiny.BENCH / "runners" / "serve.py")
READERS = {"engine.prefill_ms": "qwen2vl-doc-prefill", "prefill.head_ms": "qwen2vl-doc-prefill",
           "engine.decode_step_ms": "qwen2vl-chat-decode",
           "decode.attn_core_ms": "qwen2vl-chat-decode", "decode.mlp_ms": "qwen2vl-chat-decode"}


@pytest.mark.parametrize("cell", sorted(set(READERS.values())))
def test_the_span_readers_are_listed_for_their_cells_after_the_others(cell):
    names = [m["name"] for m in Cell(tiny.ROOT, cell).metrics("per_layer")]
    mine = [n for n in names if n in READERS]
    assert set(mine) == {n for n, c in READERS.items() if c == cell}
    assert names[-len(mine):] == mine  # read once the others are
    for name in mine:
        m = [m for m in Cell(tiny.ROOT, cell).bench["per_layer"] if m["name"] == name][0]
        assert (m["source"], m["unit"], m["better"]) == ("program_span", "ms", "lower")


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_span_reader_reads_nothing_without_a_card(name):
    run = SimpleNamespace(device=torch.device("cpu"))
    assert load_module(tiny.BENCH / "metrics" / f"{name}.py").read(run) is None


@pytest.fixture
def tiny_run(checkout):
    run = SERVE.ServeRun(Cell(checkout, "tiny-vlm.image"), 5, 0.1, "cpu", time.perf_counter())
    run.setup()
    return run


def test_the_traced_work_gives_a_number_a_step_for_each_span_read(tiny_run):
    from repro_torch import trace

    t = tiny_run.traffic
    gen = spans.collect(tiny_run, "generate", trace)
    steps = (t.new - 1) * int(tiny_run.cell.check["trace_calls"])
    for name in ("serve.decode", "serve.decode/attn.core", "serve.decode/mlp"):
        assert len(gen["spans"][name]) == steps and min(gen["spans"][name]) > 0
    assert len(gen["spans"]["serve.generate"]) == int(tiny_run.cell.check["trace_calls"])
    pre = spans.collect(tiny_run, "prefill", trace)
    for name in ("serve.prefill", "serve.prefill/head"):
        assert len(pre["spans"][name]) == int(tiny_run.cell.check["prefill_reps"])
    assert "serve.decode" not in pre["spans"] and not trace.is_on()
    assert {"graph.captures", "graph.replays", "graph.capture_ms"} <= set(pre["counters"])
    text = spans.table("generate", gen)
    assert "serve.decode/attn.core" in text and "graph.captures=" in text
