"""What the program's tracing costs in a benchmark cell, and what its spans say
of each call.

    python3 experiments/trace_cost.py --workload qwen2vl-chat-decode \\
        --seed 4026531841 [--seconds 51] [--turns off on on off] \\
        [--out build/trace_cost.json]

from the root of a checkout, on a card. Each turn is a whole run of the
cell as ``bench/run.py`` makes it (``bench/runners/serve.py``: set-up,
then the closed-loop window), in one process, one after the other on one
card. An ``on`` turn runs set-up and window inside ``trace.enabled()``, so
its graphs are captured traced from the start; an ``off`` turn runs as the
benchmark does. Printed for each turn: the cell's end-to-end metrics by
the benchmark's own readers; for an ``on`` turn each window call's host
seconds beside its ``serve.generate``, ``serve.prefill`` and summed
``serve.decode`` and ``serve.sample`` device ms; for the first ``off`` turn
the per-layer metrics ``prefill_ms`` / ``decode_step_ms`` (events around
engine calls, from outside) beside the spans' ``engine.prefill_ms`` /
``engine.decode_step_ms``, every span's median, the longest idle gaps of
a profiled call and where they lie, and the device ms of an eager prefill
and decode step of an eighth of the rows by span and kind of kernel.
Nothing of ``bench/`` is changed.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

import torch  # noqa: E402

from common import Cell, load_module  # noqa: E402
from repro_torch import trace  # noqa: E402

SERVE = load_module(ROOT / "bench" / "runners" / "serve.py")


def metric(name: str, run):
    return load_module(ROOT / "bench" / "metrics" / f"{name}.py").read(run)


def per_call(calls: list, recs: list) -> list[dict]:
    """Each window call's host seconds beside its spans' device ms."""
    out, cur = [], {"serve.prefill": 0.0, "serve.decode": 0.0, "serve.sample": 0.0, "steps": 0}
    for rec in recs:
        if rec["name"] == "serve.generate":
            cur["serve.generate"] = rec["ms"]
            out.append(cur)
            cur = {"serve.prefill": 0.0, "serve.decode": 0.0, "serve.sample": 0.0, "steps": 0}
        elif rec["name"] in cur:
            cur[rec["name"]] += rec["ms"]
            cur["steps"] += rec["name"] == "serve.decode"
    for (a, b), row in zip(calls, out, strict=True):
        row["host_ms"] = (b - a) * 1e3
    return out


def idle_gaps(r, top: int = 10) -> list[dict]:
    """The longest idle gaps of the device over one profiled stretch of whole
    calls, as ``call_trace`` profiles it (tracing off), each with where it
    lies: inside a ``serve.generate`` range or not, the innermost host event
    at its start other than the stretch's own ``bench.calls``, the innermost
    ``serve.*`` / ``graph.*`` range there, and the host events that take
    most of it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from common import merge, trace_events

    t = r.traffic
    batches = [t.batch(i + 1, warm=True) for i in range(int(r.cell.check.get("trace_calls", 1)))]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.calls"):
            for b in batches:
                r.engine.generate(b, t.new).cpu()
    dev, host = trace_events(prof)
    (t0, t1), = [(a, b) for n, a, b in host if n == "bench.calls"]
    busy = merge([(max(a, t0), min(b, t1)) for _, a, b in dev if b > t0 and a < t1])
    gaps, edge = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    by_len = sorted(host, key=lambda e: e[2] - e[1])  # innermost first

    def at(x, keep=lambda n: True):
        return next((n for n, a, b in by_len if a <= x < b and n != "bench.calls" and keep(n)),
                    None)

    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        inner = [(n, (e - s) / 1e3) for n, s, e in host
                 if a <= s < b and e - s >= 0.2 * (b - a) and n != "bench.calls"]
        out.append({"us": (b - a) / 1e3, "from_start_us": (a - t0) / 1e3,
                    "in_generate": any(s <= a and b <= e for n, s, e in host
                                       if n == "serve.generate"),
                    "host_at_start": at(a),
                    "span_at_start": at(a, lambda n: n.startswith(("serve.", "graph."))),
                    "span_at_end": at(b - 1, lambda n: n.startswith(("serve.", "graph."))),
                    "longest_inside": sorted(inner, key=lambda x: -x[1])[:3]})
    return out


SPANS = ("embed", "attn.qkv", "attn.core", "attn.out", "mlp", "head")


def kind_of(kernel: str) -> str:
    low = kernel.lower()
    if "copy" in low:
        return "copy"
    if "flash" in low:
        return "kernel 3"
    if any(k in low for k in ("gemm", "nvjet", "xmma", "gemv", "cutlass")):
        return "product"
    return "other"


def op_split(r, rows: int) -> dict:
    """Device ms of one eager prefill (and one eager decode step) of ``rows``
    of the cell's rows, with tracing on under the profiler, by span and kind
    of kernel (copy, product, kernel 3, other): each kernel goes to the span
    whose ``record_function`` range was open where it was launched."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    t = r.traffic
    batch = {k: v[:rows] for k, v in t.batch(0, warm=True).items()}
    model = Model(SERVE.model_config(r.as_run), params=r.weights, device=r.device)
    eager = ServeEngine(model, ServeConfig(max_len=t.max_len), jit=False)
    torch.cuda.synchronize()
    with trace.enabled(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        last, state = eager.prefill(batch)
        if t.new > 1:
            eager.decode(state, torch.argmax(last, -1).to(torch.int32), t.prompt)
        torch.cuda.synchronize()
    trace.reset()
    out: dict = {}
    for fe in prof.events():
        if not getattr(fe, "kernels", None):
            continue
        span, step, up = None, None, fe
        while up is not None:
            if span is None and up.name in SPANS:
                span = up.name
            if up.name in ("serve.prefill", "serve.decode"):
                step = up.name
                break
            up = up.cpu_parent
        key = f"{step}/{span or '(outside the spans)'}"
        for k in fe.kernels:
            row = out.setdefault(key, {})
            row[kind_of(k.name)] = row.get(kind_of(k.name), 0.0) + k.duration / 1e3
    return {"rows": rows, "ms": out}


def turn(cell, mode: str, seed: int, seconds: float, first_off: bool, device: str) -> dict:
    """One run of the cell with tracing ``mode`` ("on" or "off")."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()  # setup_s: from here, not from the process's start
    r = SERVE.ServeRun(cell, seed, seconds, device, t_start)
    row: dict = {"mode": mode}
    with trace.enabled() if mode == "on" else contextlib.nullcontext():
        r.setup()
        trace.reset()
        r.window()
        recs = trace.records()
    r.read_peak()
    for m in cell.metrics("end_to_end"):
        row[m["name"]] = metric(m["name"], r)
    row["calls_s"] = [b - a for a, b in r.calls]
    if mode == "on":
        row["per_call"] = per_call(r.calls, recs)
    elif first_off and cuda:  # the outside timings are CUDA events
        for m in cell.metrics("per_layer"):
            if m["source"] == "program_span":
                row[m["name"]] = metric(m["name"], r)
        # every span's median a step, from the spans' readers' traced work
        row["spans"] = {kind: {"median_ms": {k: statistics.median(v)
                                             for k, v in got["spans"].items()},
                               "steps": {k: len(v) for k, v in got["spans"].items()},
                               "counters": got["counters"]}
                        for kind, got in r.__dict__.get("_bench_spans", {}).items() if got}
        row["idle_gaps"] = idle_gaps(r)
    r.free_program()
    if first_off and cuda:
        row["op_split"] = op_split(r, max(1, r.traffic.batch_size // 8))  # an eighth: room
    del r
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    trace.reset()
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--turns", nargs="+", default=["off", "on", "on", "off"])
    ap.add_argument("--out", default="build/trace_cost.json")
    ap.add_argument("--device", default="cuda", help="cpu to rehearse at a tiny cell's size")
    ap.add_argument("--root", type=Path, default=ROOT, help="the checkout whose cells to run")
    args = ap.parse_args()
    cell = Cell(args.root, args.workload)
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
            if args.device == "cuda" else args.device)
    rows = []
    for i, mode in enumerate(args.turns):
        first_off = mode == "off" and "off" not in args.turns[:i]
        rows.append(turn(cell, mode, args.seed, args.seconds, first_off, args.device))
        print(json.dumps({k: v for k, v in rows[-1].items()
                          if k not in ("per_call", "spans", "idle_gaps", "op_split")}),
              flush=True)
    out = {"workload": args.workload, "seed": args.seed, "card": card, "turns": rows}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
