"""A benchmark checkout in a temporary directory with two tiny cells, a MoE
and a VLM at CPU-test sizes, built only by adding files: the harness finds
them by the names in their ``BENCHMARK.json``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

TINY = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 96, "vocab": 256,
        "head_dim": 16, "norm_eps": 1e-6, "dtype": "bfloat16"}
CONFIGS = {
    "tiny-moe": {"as_run": {**TINY, "name": "tiny-moe", "family": "moe", "dtype": "float32",
                            "moe": {"n_experts": 8, "top_k": 3, "capacity": 1.25},
                            "rope": "rope", "rope_theta": 10000.0},
                 "routed_scaling_factor": 2.0,
                 "modules": {"counts": "transformer", "reference": "moe"}},
    "tiny-vlm": {"as_run": {**TINY, "name": "tiny-vlm", "family": "vlm", "qkv_bias": True,
                            "rope": "mrope", "rope_theta": 1e6, "mrope_sections": [2, 3, 3],
                            "modality": "vision", "tie_embeddings": True},
                 "modules": {"counts": "transformer", "reference": "transformer"}},
}
TRAFFIC = {
    "tiny-text": {"runner": "serve", "batch": 4, "text_tokens": 24, "image_grid": None,
                  "new_tokens": 6},
    "tiny-image": {"runner": "serve", "batch": 3, "text_tokens": 10, "image_grid": [3, 2],
                   "new_tokens": 5},
}
CELLS = {"tiny-moe.text": ("tiny-moe", "tiny-text"), "tiny-vlm.image": ("tiny-vlm", "tiny-image")}
# The widest gap against the float32 reference over 8 requests, seeds 1-5, and
# its float8 control's: the MoE in float32 (in bf16 its routes flip at random,
# as at full size) 0.0 on every seed, its control 0.62-2.09; the VLM in bf16
# (its tied head gives small logits) 0.000-0.0032, its control 0.021-0.053.
LIMITS = {"tiny-moe.text": 0.05, "tiny-vlm.image": 0.012}


def make(tmp: Path) -> Path:
    """A checkout at ``tmp``: the real ``bench/`` (a copy) and the tiny
    cells' files; the program is read from this repository's ``src``."""
    shutil.copytree(BENCH, tmp / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    for name, cfg in CONFIGS.items():
        (tmp / "bench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, t in TRAFFIC.items():
        (tmp / "bench" / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for name in CELLS:
        check = {"sample_requests": 3, "reference_rows": 2, "trace_calls": 1, "prefill_reps": 2,
                 "limits": {"max_gap": {"at_most": LIMITS[name]}}}
        (tmp / "bench" / "cells" / f"{name}.json").write_text(json.dumps(check))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": n, "source": "test", "file": f"bench/configs/{n}.json",
                         "reduced": [], "why": "test"} for n in CONFIGS]
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"}
                          for n, (c, t) in CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = list(CELLS)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
