"""The harness: the format of ``BENCHMARK.json`` and
the files its names point to, a run's last line, cells added by adding
files, what the harness may import, and its refusals."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

import tiny
from common import Cell, load_module

ROOT, BENCH = tiny.ROOT, tiny.BENCH
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_benchmark_json_keeps_its_format():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"][1].startswith("bench/")
    assert 1 <= SPEC["run_seconds"] <= 51
    names = set()
    for kind, keys in KEYS.items():
        for entry in SPEC[kind]:
            assert set(entry) - {"workloads"} == keys, entry
            assert NAME.match(entry["name"]) and entry["name"] not in names
            names.add(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reports = [m for m in SPEC["end_to_end"] + SPEC["per_layer"]
                   if w["name"] in m.get("workloads", [w["name"]])]
        assert {"setup_s"} < {m["name"] for m in reports if m in SPEC["end_to_end"]}
        assert any(m in SPEC["per_layer"] for m in reports)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_file_a_cell_names_is_found_and_valid(workload):
    cell = Cell(ROOT, workload)
    a = cell.config["as_run"]
    load_module(BENCH / "runners" / "serve.py").model_config(a)  # the program takes it
    for key in ("counts", "reference"):
        assert (BENCH / key / f"{cell.config['modules'][key]}.py").is_file()
    assert (BENCH / "runners" / f"{cell.traffic['runner']}.py").is_file()
    assert cell.check["limits"] and cell.check["sample_requests"] >= 1
    for m in cell.metrics("end_to_end") + cell.metrics("per_layer"):
        assert callable(cell.module("metrics", m["name"]).read)
    entry = [c for c in SPEC["configs"] if c["name"] == cell.workload["config"]][0]
    for key in entry["reduced"]:  # every change from the source is named, and no width
        assert key in cell.config and not re.search(r"(_dim|_rank|size|width)$", key)


def test_configs_agree_with_what_they_run():
    for entry in SPEC["configs"]:
        c = json.loads((ROOT / entry["file"]).read_text())
        a = c["as_run"]
        assert c["source"] == entry["source"] and c["reduced"] == entry["reduced"]
        assert (a["n_layers"], a["d_model"], a["n_heads"], a["n_kv_heads"], a["vocab"]) == (
            c["num_hidden_layers"], c["hidden_size"], c["num_attention_heads"],
            c["num_key_value_heads"], c["vocab_size"])
        assert a["norm_eps"] == c["rms_norm_eps"] and a["rope_theta"] == c["rope_theta"]
        if a["family"] == "moe":
            assert (a["d_ff"], a["moe"]["n_experts"], a["moe"]["top_k"]) == (
                c["moe_intermediate_size"], c["n_routed_experts"], c["num_experts_per_tok"])
        else:
            assert a["d_ff"] == c["intermediate_size"]


def _run(root: Path, workload: str, seed: int = 11) -> tuple[dict, dict]:
    run = load_module(BENCH / "run.py")
    return run.execute(Cell(root, workload), seed=seed, seconds=0.3, trace=False, device="cpu",
                       t_start=time.perf_counter())


def test_the_last_line_has_the_result_keys_and_checked_last(checkout, capsys):
    run = load_module(BENCH / "run.py")
    run.emit(*_run(checkout, "tiny-vlm.image"))
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checked"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert {"setup_s", "gen_tok_s", "request_p95_ms"} <= set(line["metrics"])
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert err.strip().splitlines()[-1].startswith("max_gap ")


def test_a_cell_config_traffic_and_metric_are_added_by_adding_files(checkout):
    """The tiny cells exist only as added files; a new metric is one more file
    and one more entry."""
    (checkout / "bench" / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n    return len(run.calls) / run.window_s\n")
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock"})
    (checkout / "BENCHMARK.json").write_text(json.dumps(spec))
    result, _ = _run(checkout, "tiny-moe.text")
    assert result["correct"] and result["metrics"]["calls_per_s"]["value"] > 0


@pytest.mark.parametrize("warm_calls", [None, 3])
def test_a_cells_warm_calls_set_the_whole_calls_of_set_up(checkout, monkeypatch, warm_calls):
    """Set-up captures on a 2-token call, then runs ``warm_calls`` whole calls
    (1 where the cell names none) before the window."""
    from repro_torch.serve.engine import ServeEngine

    path = checkout / "bench" / "cells" / "tiny-vlm.image.json"
    check = json.loads(path.read_text())
    if warm_calls is not None:
        check["warm_calls"] = warm_calls
    path.write_text(json.dumps(check))
    lengths = []
    generate = ServeEngine.generate

    def counted(self, batch, new, **kw):
        lengths.append(new)
        return generate(self, batch, new, **kw)

    monkeypatch.setattr(ServeEngine, "generate", counted)
    serve = load_module(checkout / "bench" / "runners" / "serve.py")
    run = serve.ServeRun(Cell(checkout, "tiny-vlm.image"), 11, 0.3, "cpu", time.perf_counter())
    run.setup()
    assert lengths == [2] + [run.traffic.new] * (warm_calls or 1)


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_in_bench_imports_jax_the_jax_package_or_its_benchmarks():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "contextlib", "math", "sys", "importlib",
                                  "pathlib", "torch"}, path


def _cli(cwd: Path, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "bench/run.py", "--workload", "qwen2vl-chat-decode",
                           "--seed", "1", "--seconds", "1", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _cli(ROOT)
    assert proc.returncode == 2 and proc.stdout == "" and "CUDA" in proc.stderr


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's paths."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = _cli(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
