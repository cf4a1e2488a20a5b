"""A run with the timed path broken underneath comes out not correct, once for
each fault a serving cell can have (it has one card, so no exchange between
cards to leave out), and the control, the reference in float8 in the
program's place, fails where the program passes.

The runs skip the harness's look for a card and go through the rest of a
run on the CPU at the tiny cells' sizes. ``test_control_fails_the_cells_limits``
runs the control at a cell's own size on the card."""

from __future__ import annotations

import json
import time

import pytest
import torch

import tiny
from common import Cell, load_module

RUN = load_module(tiny.BENCH / "run.py")
CALIBRATE = load_module(tiny.BENCH / "calibrate.py")
SERVE = load_module(tiny.BENCH / "runners" / "serve.py")


def _result(root, workload: str, seed: int = 3) -> dict:
    return RUN.execute(Cell(root, workload), seed=seed, seconds=0.3, trace=False, device="cpu",
                       t_start=time.perf_counter())[0]


def _sampling(root, n: int):
    for name in tiny.CELLS:
        path = root / "bench" / "cells" / f"{name}.json"
        check = json.loads(path.read_text())
        check["sample_requests"] = n
        path.write_text(json.dumps(check))
    return root


@pytest.fixture
def checkout(tmp_path):
    """Every request of the window compared, so a fault in any row shows."""
    return _sampling(tiny.make(tmp_path), 1000)


def _altered_token(monkeypatch):
    from repro_torch.serve.engine import ServeEngine

    sample = ServeEngine._sample
    monkeypatch.setattr(ServeEngine, "_sample", lambda self, logits, gen: (
        (sample(self, logits, gen) + 1) % logits.shape[-1]).to(torch.int32))


def _state_unchanged(monkeypatch):
    from repro_torch.models import transformer

    monkeypatch.setattr(transformer, "write_slice", lambda dst, src, start, dim=1: None)


def _half_the_batch(monkeypatch):
    """The second half of each batch is served the first half's prompts."""
    from repro_torch.serve.engine import ServeEngine

    prefill = ServeEngine.prefill

    def half(self, batch):
        batch = dict(batch)
        for key in ("tokens", "patch_embeds"):
            if key in batch:
                t = batch[key].clone()
                n = t.shape[0] // 2
                t[n : 2 * n] = t[:n]
                batch[key] = t
        return prefill(self, batch)

    monkeypatch.setattr(ServeEngine, "prefill", half)


FAULTS = {"a token altered where it is produced": _altered_token,
          "a decode step that leaves its state unchanged": _state_unchanged,
          "half of the batch left out": _half_the_batch}


@pytest.mark.parametrize("workload", sorted(tiny.CELLS))
def test_a_sound_run_is_correct(checkout, workload):
    assert _result(checkout, workload)["correct"] is True


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", sorted(tiny.CELLS))
def test_a_fault_underneath_makes_the_run_not_correct(checkout, monkeypatch, workload, fault):
    FAULTS[fault](monkeypatch)
    result = _result(checkout, workload)
    assert result["correct"] is False, result["checked"]


def _readings(root, workload: str, seed: int, device: str) -> tuple[dict, dict]:
    """The program's numbers and the control's on one seed's sample."""
    cell = Cell(root, workload)
    prog, ctl = CALIBRATE.readings(cell, seed, device, control=True)
    return SERVE.numbers(prog.flatten().cpu()), SERVE.numbers(ctl.flatten().cpu())


def _fails(check: dict, got: dict) -> bool:
    """Whether ``got`` fails the cell's limits, by the run's own verdict."""
    return not SERVE.verdict(got, check["limits"])[0]


@pytest.mark.parametrize("workload", sorted(tiny.CELLS))
def test_control_reads_worse_than_the_program(tmp_path, workload):
    """At the tiny sizes, on the CPU: on each seed the control's widest gap
    lies above the program's and fails the tiny cell's limit."""
    root = _sampling(tiny.make(tmp_path), 8)
    check = Cell(root, workload).check
    for seed in (1, 2, 3):
        prog, ctl = _readings(root, workload, seed, "cpu")
        assert ctl["max_gap"] > prog["max_gap"] and _fails(check, ctl), (seed, prog, ctl)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("workload", ["qwen2vl-chat-decode", "qwen2vl-doc-prefill"])
def test_control_fails_the_cells_limits(cuda, workload):
    """At the cell's own size on the card, three seeds: the program passes the
    cell's limits and the control fails them."""
    check = Cell(tiny.ROOT, workload).check
    for seed in (101, 202, 303):
        prog, ctl = _readings(tiny.ROOT, workload, seed, "cuda")
        assert not _fails(check, prog) and _fails(check, ctl), (seed, prog, ctl)
