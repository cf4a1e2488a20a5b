"""Why does the chat cell's traced decode step (``engine.decode_step_ms``) read
~1.6% above the untraced step timed from outside (``decode_step_ms``) in
some runs and ~5% in others?

    python3 experiments/decode_drift.py [--seed 13958643711] [--seconds 20]
        [--plan U P T U T U] [--idle 15] [--out build/decode_drift.json]

from the root of a checkout, on a card. Sets up the chat cell as
``bench/run.py`` does (``bench/runners/serve.py``) and runs its window, then
the stages of ``--plan`` in order:

* ``U``: the untraced decode step timed from outside (a CUDA event pair
  around each of the cell's consecutive ``engine.decode`` steps, as
  ``decode_step_ms`` times them all);
* ``P``: the profiled stretch that ``idle.gen`` reads (``call_trace``);
* ``T``: a traced ``generate`` (the first captures the traced pair and reads
  as ``bench/spans.py`` does), then the same steps timed from outside with
  tracing on;
* ``I``: the card left idle for ``--idle`` seconds.

A ``U`` or ``T`` line gives the medians over the steps that replayed each
graph of the traced pair (``g0``, ``g1``; a ``U`` line's are its even and
odd steps, one graph) and over all, the ``serve.decode`` span's and the
summed ``mlp`` and ``attn.core`` spans' for a ``T``, and the median of each
tenth of the steps in order (``tenths``). Each line carries the card's
clocks, power, temperatures and clock event reasons as ``nvidia-smi``
sampled them every 100 ms during the stage (``card``: the least, median
and most of each field).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

import torch  # noqa: E402

import spans  # noqa: E402
from common import Cell, load_module  # noqa: E402
from repro_torch import trace  # noqa: E402

SERVE = load_module(ROOT / "bench" / "runners" / "serve.py")
FIELDS = ["clocks.sm", "clocks.mem", "power.draw", "temperature.gpu", "temperature.memory",
          "clocks_event_reasons.active"]


class Card:
    """``nvidia-smi`` sampling ``FIELDS`` every 100 ms in the background."""

    def __init__(self) -> None:
        fields = FIELDS
        if subprocess.run(["nvidia-smi", f"--query-gpu={','.join(fields)}",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, check=False).returncode != 0:
            fields = FIELDS[:4]
        self.fields, self.samples = fields, []
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}", "--format=csv,noheader,nounits",
             "-lms", "100"], stdout=subprocess.PIPE, text=True)
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.samples.append((time.perf_counter(), [v.strip() for v in line.split(",")]))

    def between(self, a: float, b: float) -> dict:
        rows = [vals for t, vals in self.samples if a <= t <= b]
        out: dict = {"samples": len(rows)}
        for i, name in enumerate(self.fields):
            vals = [r[i] for r in rows if i < len(r)]
            try:
                nums = sorted(float(v) for v in vals)
                out[name] = [nums[0], statistics.median(nums), nums[-1]] if nums else None
            except ValueError:
                out[name] = sorted(set(vals))
        return out

    def stop(self) -> None:
        self.proc.terminate()
        self.proc.wait()


def med(values: list[float]) -> float:
    return round(statistics.median(values), 4) if values else float("nan")


def by_graph(values: list[float], first: int = 0) -> dict:
    """Medians over the steps that replayed the pair's graph 0, graph 1 (the
    first step being traced turn ``first``) and all, and of each tenth of
    the steps."""
    n = len(values)
    return {"g0": med(values[first % 2::2]), "g1": med(values[1 - first % 2::2]),
            "all": med(values),
            "tenths": [med(values[i * n // 10:(i + 1) * n // 10]) for i in range(10)]}


def turn(r) -> int:
    """The traced turn the decode step's next traced call takes."""
    return next(iter(r.engine._decode._turns.values()), -1) + 1


def outside_steps(r) -> list[float]:
    """Each of the cell's ``new - 1`` decode steps, timed by a CUDA event pair
    around its ``engine.decode`` call."""
    t = r.traffic
    last, state = r.engine.prefill(t.batch(0, warm=True))
    tokens = torch.argmax(last, dim=-1).to(torch.int32)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(t.new)]
    marks[0].record()
    for i in range(t.new - 1):
        _, state = r.engine.decode(state, tokens, t.prompt + i)
        marks[i + 1].record()
    marks[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=13958643711)
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--plan", nargs="+", default=["U", "P", "T", "U", "T", "U"],
                    choices=["U", "P", "T", "I"])
    ap.add_argument("--idle", type=float, default=15)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    card = Card()
    r = SERVE.ServeRun(Cell(ROOT, "qwen2vl-chat-decode"), args.seed, args.seconds, "cuda",
                       time.perf_counter())
    r.setup()
    r.window()
    t0 = time.perf_counter()
    lines, captured = [], False
    for what in args.plan:
        a = time.perf_counter()
        got: dict = {}
        if what == "U":
            got["outside"] = by_graph(outside_steps(r))
        elif what == "P":
            r.__dict__.pop("call_trace", None)  # profile anew each time
            r.call_trace
        elif what == "I":
            torch.cuda.synchronize()
            time.sleep(args.idle)
        else:
            if not captured:
                sp = spans.collect(r, "generate", trace)["spans"]  # captures the pair, then reads
                captured = True
            else:
                with trace.enabled():
                    trace.reset()
                    r.engine.generate(r.traffic.batch(0, warm=True), r.traffic.new).cpu()
                    sp = trace.spans()
            first = turn(r) - len(sp["serve.decode"])
            with trace.enabled():  # the traced pair's steps timed from outside too
                out_first = turn(r)
                outside = outside_steps(r)
                trace.reset()
            got = {"span": by_graph(sp["serve.decode"], first),
                   "mlp": by_graph(sp["serve.decode/mlp"], first),
                   "attn_core": by_graph(sp["serve.decode/attn.core"], first),
                   "outside": by_graph(outside, out_first)}
        b = time.perf_counter()
        line = {"at_s": round(a - t0, 1), "s": round(b - a, 1), "what": what, **got,
                "card": card.between(a, b)}
        lines.append(line)
        print(json.dumps(line), flush=True)
    card.stop()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()
