#!/usr/bin/env python3
"""Time the decode-attention kernel against the plain route it replaces
(``layers.chunked_attention`` at S == 1, the whole cache widened to
float32), on one CUDA card.

    python3 experiments/decode_attention_ab.py [--reps 20] [--out build/decode_ab.json] \
        [--variant NAME:kStagesMax=2,kMinBlocks=3,kSteps=4 ...]

At the benchmark's two decode shapes (qwen2-vl-2b, bf16: the chat cell's
256 rows at a 768-slot cache filled to 512-767, the doc cell's 16 rows at
8200 filled to 8192-8199) each route runs as a captured decode runs it: a
CUDA graph of one call a layer (28 calls, a position tensor each, spread
over the fill), replayed behind a device spin and timed by CUDA events
(median of ``--reps`` replays, divided by 28).  Beside each time: the live
cache's bytes and their bound at 3.35 TB/s (the kernel's share of it), the
whole cache's bound, and the kernel's largest difference from the plain
route.  Every instantiation of the kernel (both types, every head dim, 1-8
query heads a block) is also run once against the plain route, and the
ptxas report of the build (registers and spills by instantiation) is
summarised.  ``--core`` also lists the device kernels that one eager
decode step of qwen2-vl-2b (full width, 2 layers, the chat cell's 256
rows at a 768-slot cache) launches inside its ``attn.core`` spans, at a
0-d position tensor as a captured step runs it: each kernel goes to the
span whose ``record_function`` range was open where it was launched (the
two kernels launched through ``ctypes`` have no aten op and show under
the span's own range).  Each ``--variant`` is the kernel's source with those
constants changed, built with the same flags into the git-ignored
``build/`` and timed in turns beside the kernel and the plain route (the
wrapper's plan follows the changed constants).  The last line of output
is the JSON record, also written to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

HBM = 3.35e12  # bytes a second
LAYERS = 28
SHAPES = {  # B, H, K, T, hd; the positions a call of the cell decodes at
    "chat": ((256, 12, 2, 768, 128), range(512, 768)),
    "doc": ((16, 12, 2, 8200, 128), range(8192, 8200)),
}
SPIN_CYCLES = 2_000_000  # ~1 ms: the replay is queued before the card reaches it
# a variant's source constant -> the wrapper's constant that mirrors it
MIRRORS = {"kSteps": "_STEPS", "kStagesMax": "_STAGES_MAX", "kStageBudget": "_STAGE_BUDGET",
           "kMinBlocks": None, "waves": "_WAVES"}
PLAN_ONLY = {"waves"}  # knobs of the wrapper's plan alone: the package's build runs them


def build_variants(specs: dict) -> dict:
    """Build each variant of ``decode_attention.cu`` in parallel; return
    name -> (library, constants, ptxas report)."""
    from repro_torch.kernels import _build

    src = (_build._CSRC / "decode_attention.cu").read_text()
    out_dir = _build.build_dir() / "decode_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, consts in specs.items():
        if set(consts) <= PLAN_ONLY:
            continue
        text = src
        for key, val in consts.items():
            if key in PLAN_ONLY:
                continue
            text, n = re.subn(rf"constexpr int {key} = \d+;", f"constexpr int {key} = {val};",
                              text)
            if n != 1:
                raise ValueError(f"variant {name}: no constant {key} in the source")
        path = out_dir / f"{name}.cu"
        path.write_text(text)
        lib = path.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.flags("decode_attention"), "-I", str(_build._CSRC),
               "-o", str(lib), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib, consts)
    built = {name: (_build.load_library("decode_attention"), consts, "")
             for name, consts in specs.items() if set(consts) <= PLAN_ONLY}
    for name, (proc, lib, consts) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log[-3000:]}")
        built[name] = (ctypes.CDLL(str(lib)), consts, log)
    return built


@contextlib.contextmanager
def swapped(lib, consts):
    """The wrapper launching ``lib`` with its plan at ``consts``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da

    saved_lib = _build._LIBS.get("decode_attention")
    saved = {attr: getattr(da, attr) for attr in MIRRORS.values() if attr}
    _build._LIBS["decode_attention"] = lib
    for key, val in consts.items():
        if MIRRORS[key]:
            setattr(da, MIRRORS[key], val)
    try:
        yield
    finally:
        _build._LIBS["decode_attention"] = saved_lib
        for attr, val in saved.items():
            setattr(da, attr, val)


def _replay_ms(graph, reps: int) -> float:
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _captured(fn):
    """A graph of ``fn()``, warmed up on a side stream first."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def time_shape(name: str, reps: int, variants: dict) -> dict:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_plan
    from repro_torch.models.layers import chunked_attention

    (B, H, K, T, hd), fills = SHAPES[name]
    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
               for s in ((B, 1, H, hd), (B, T, K, hd), (B, T, K, hd)))
    step = max(1, len(fills) // LAYERS)
    positions = [fills[(i * step) % len(fills)] for i in range(LAYERS)]
    idx = [torch.tensor(p, dtype=torch.int32, device=dev) for p in positions]

    def kernel():
        return [ops.decode_attention(q, k, v, q_offset=i, kv_len=i + 1) for i in idx]

    def plain():
        return [chunked_attention(q, k, v, q_offset=i, kv_len=i + 1, kv_chunk=T) for i in idx]

    rec = {"shape": {"B": B, "H": H, "K": K, "T": T, "hd": hd, "dtype": "bfloat16"},
           "positions": [positions[0], positions[-1]]}
    graphs = {"kernel": _captured(kernel), "plain": _captured(plain)}
    for vname, (lib, consts, _) in variants.items():
        with swapped(lib, consts):
            graphs[vname] = _captured(kernel)
    for graph, _ in graphs.values():
        graph.replay()
    torch.cuda.synchronize()
    want = graphs["plain"][1]
    diffs = {route: max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(out, want, strict=True))
             for route, (_, out) in graphs.items() if route != "plain"}
    rec["max_abs_diff"] = diffs.pop("kernel")
    rec["variants_max_abs_diff"] = diffs
    # in turns: kernel, variants, plain, then back
    order = ["kernel", *variants, "plain"]
    times = {route: [] for route in order}
    for route in order + order[::-1]:
        times[route].append(_replay_ms(graphs[route][0], reps) / LAYERS)
    live = statistics.mean(B * K * (p + 1) * hd * 2 * 2 for p in positions)
    bound_ms = live / HBM * 1e3
    plan = decode_plan(B, H, K, T, hd, torch.bfloat16)
    rec.update({
        "kernel_ms": times["kernel"], "plain_ms": times["plain"],
        "live_bytes": live, "live_bound_ms": bound_ms,
        "whole_cache_bound_ms": B * K * T * hd * 2 * 2 / HBM * 1e3,
        "kernel_share_of_bound": bound_ms / statistics.mean(times["kernel"]),
        "plain_over_kernel": statistics.mean(times["plain"]) / statistics.mean(times["kernel"]),
        "variants_ms": {v: times[v] for v in variants},
        "plan": {"splits": plan.splits, "split_keys": plan.split_keys, "grid": plan.grid,
                 "tile": plan.tile, "heads": plan.heads, "smem": plan.smem},
    })
    return rec


def core_kernels() -> dict:
    """Device ms by kernel name under ``serve.decode/attn.core`` of one
    eager decode step at a position tensor, with tracing on under the
    profiler."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.serve.engine import _pad_cache_to

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_arch("qwen2-vl-2b"), n_layers=2)
    model = Model(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev,
                  dtype=torch.bfloat16)
    B, P, n_text, T = 256, 256, 256, 768
    g = torch.Generator(dev).manual_seed(1)
    pos = torch.cat([torch.zeros(P, 3, dtype=torch.int32),
                     (P + torch.arange(n_text, dtype=torch.int32))[:, None].repeat(1, 3)])
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, n_text), generator=g, device=dev,
                                     dtype=torch.int32),
             "patch_embeds": torch.randn((B, P, cfg.d_model), generator=g, device=dev),
             "positions": pos[None].repeat(B, 1, 1).to(dev)}
    last, state = model.prefill(batch)
    state = _pad_cache_to(state, model, T)
    tokens = torch.argmax(last, -1).to(torch.int32)
    idx = torch.tensor(P + n_text, dtype=torch.int32, device=dev)
    model.decode_step(state, tokens, idx)  # warm-up
    torch.cuda.synchronize()
    with trace.enabled(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        with trace.span("serve.decode", dev, outer=True):
            model.decode_step(state, tokens, idx)
        torch.cuda.synchronize()
    trace.reset()
    out: dict = {}
    for fe in prof.events():
        if not getattr(fe, "kernels", None):
            continue
        up = fe
        while up is not None and up.name != "attn.core":
            up = up.cpu_parent
        if up is None:
            continue
        for k in fe.kernels:
            out[k.name[:90]] = out.get(k.name[:90], 0.0) + k.duration / 1e3
    return out


def check_instantiations() -> dict:
    """Each (type, head dim, query heads a block) once against the plain
    route, at a position tensor: the largest difference by type."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    from repro_torch.models.layers import chunked_attention

    dev = torch.device("cuda", 0)
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for hd in HEAD_DIMS:
            for heads in range(1, 9):
                g = torch.Generator(dev).manual_seed(hd + heads)
                q, k, v = (torch.randn(s, generator=g, device=dev).to(dtype)
                           for s in ((3, 1, 2 * heads, hd), (3, 300, 2, hd), (3, 300, 2, hd)))
                idx = torch.tensor(200, dtype=torch.int32, device=dev)
                got = ops.decode_attention(q, k, v, q_offset=idx, kv_len=idx + 1)
                want = chunked_attention(q, k, v, q_offset=200, kv_len=201, kv_chunk=300)
                err = float((got.float() - want.float()).abs().max())
                key = str(dtype).split(".")[-1]
                worst[key] = max(worst.get(key, 0.0), err)
    return worst


def ptxas_summary(log: str) -> dict:
    """Registers and spill bytes of each split-kernel instantiation, from
    a build's ptxas report: the widest, and every one that spills."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            out.setdefault(current, {})["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            out.setdefault(current, {})["registers"] = int(m.group(1))
    split = {k: r for k, r in out.items() if "merge" not in k}
    chat = [k for k in split if "__nv_bfloat16Li128ELi6E" in k]
    return {
        "kernels": len(out),
        "max_registers": max((r.get("registers", 0) for r in split.values()), default=0),
        "spilling": sorted(k for k, r in split.items() if r.get("spill")),
        "chat_instantiation": {k: split[k] for k in chat},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=str(ROOT / "build" / "decode_ab.json"))
    ap.add_argument("--core", action="store_true",
                    help="list the kernels under a decode step's attn.core spans")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME:CONST=VALUE,...: the kernel's source with those constants")
    args = ap.parse_args()
    import torch

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    t0 = time.perf_counter()
    _build.load_library("decode_attention")
    specs = {}
    for spec in args.variant:
        name, _, body = spec.partition(":")
        specs[name] = {k: int(v) for k, v in (kv.split("=") for kv in body.split(","))}
    t1 = time.perf_counter()
    variants = build_variants(specs) if specs else {}
    rec = {"card": card.strip(), "build_or_load_s": t1 - t0,
           "variants_build_s": time.perf_counter() - t1,
           "ptxas": ptxas_summary(_build.build_log("decode_attention")),
           "variants_ptxas": {v: ptxas_summary(log) for v, (_, _, log) in variants.items()},
           "instantiations_max_abs_diff": check_instantiations()}
    if args.core:
        rec["attn_core_kernels_ms"] = core_kernels()
        print("attn.core", json.dumps(rec["attn_core_kernels_ms"]), flush=True)
    for name in SHAPES:
        rec[name] = time_shape(name, args.reps, variants)
        print(name, json.dumps(rec[name]), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
