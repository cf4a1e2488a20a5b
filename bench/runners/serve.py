"""Serving cells: the program's ``ServeEngine.generate`` in a closed loop.

Set-up draws the weights and builds ``ServeEngine(Model(cfg, params=...),
ServeConfig(max_len=prompt + new), jit=True)`` (CUDA graphs of the prefill
and the decode step), then warms both graphs up on a batch of the cell's
shapes. The window runs back-to-back ``generate`` calls, each on a new
batch and ended by bringing its tokens to the host; no call starts once
``--seconds`` have passed since the first began. A request's latency runs
from its call's start to its tokens on the host.

A traced run (``--trace 1``) also runs the window (the per-layer shares of
the peak read its time), then measures what its per-layer metrics ask for
(each a lazy property below, so only what the cell reports is measured),
and a profiled stretch of whole calls for the device's busy share and the
breakdown.

The check runs once the window has closed, the peak memory has been read
and the engine is freed: a sample of the finished requests, drawn from the
seed, through the plain reference (``reference/<name>.py``, named by the
configuration) over each prompt and its served tokens; the number compared
is the widest gap by which a served token's logit lies below the
reference's best there.
"""

from __future__ import annotations

import functools
import gc
import time

import numpy as np
import torch

import weights as weights_mod
from common import SAMPLE, peaks, reduce_trace, sub_seed, trace_events
from traffic import Traffic


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=acts)


def model_config(as_run: dict):
    """The program's ``ModelConfig`` for a configuration's ``as_run`` fields."""
    from repro_torch.configs.base import ModelConfig, MoESpec

    kw = dict(as_run)
    if kw.get("moe"):
        kw["moe"] = MoESpec(**kw["moe"])
    for key in ("mrope_sections", "block_pattern"):
        if key in kw:
            kw[key] = tuple(kw[key])
    return ModelConfig(**kw)


class ServeRun:
    def __init__(self, cell, seed: int, seconds: float, device, t_start: float) -> None:
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.device = torch.device(device)
        self.t_start = t_start
        self.as_run = cell.config["as_run"]
        self.dtype = getattr(torch, self.as_run["dtype"])
        self.counts = cell.module("counts", cell.config["modules"]["counts"])
        self.reference = cell.module("reference", cell.config["modules"]["reference"])
        self.traffic = Traffic(cell.traffic, self.as_run, seed, self.device, self.dtype)
        cuda = self.device.type == "cuda"
        self.peak = peaks(torch.cuda.get_device_name(self.device)) if cuda else None

    # ---- set-up and the window ------------------------------------------
    def setup(self) -> None:
        from repro_torch.models.model import Model
        from repro_torch.serve.engine import ServeConfig, ServeEngine

        shapes = self.counts.param_shapes(self.cell.config)
        self.weights = weights_mod.draw(shapes, self.seed, self.device, self.dtype)
        model = Model(model_config(self.as_run), params=self.weights, device=self.device)
        self.engine = ServeEngine(model, ServeConfig(max_len=self.traffic.max_len), jit=True)
        warm = self.traffic.batch(0, warm=True)
        self.engine.generate(warm, 2).cpu()  # captures the prefill and the decode step
        # whole calls more (the cell's ``warm_calls``, 1 if it names none): the
        # window's first call ran ~5% slower than the rest (H100, a 16 x 512
        # MoE decode) after a warm-up of short calls alone
        for _ in range(int(self.cell.check.get("warm_calls", 1))):
            self.engine.generate(warm, self.traffic.new).cpu()
        _sync(self.device)

    def window(self, calls: int | None = None) -> None:
        """The closed loop for ``--seconds`` (or exactly ``calls`` calls)."""
        self.calls: list[tuple[float, float]] = []
        self.served: list[torch.Tensor] = []
        start = None
        while start is None or (len(self.calls) < calls if calls is not None
                                else time.perf_counter() - start < self.seconds):
            batch = self.traffic.batch(len(self.calls))
            t0 = time.perf_counter()
            if start is None:
                start = t0
                self.setup_s = t0 - self.t_start
            out = self.engine.generate(batch, self.traffic.new).cpu()
            self.calls.append((t0, time.perf_counter()))
            self.served.append(out)
        self.window_s = self.calls[-1][1] - self.calls[0][0]
        self.requests = len(self.calls) * self.traffic.batch_size
        self.latencies_s = [b - a for a, b in self.calls for _ in range(self.traffic.batch_size)]

    def read_peak(self) -> None:
        self.memory_peak_bytes = (torch.cuda.max_memory_reserved(self.device)
                                  if self.device.type == "cuda" else 0)

    @property
    def window_flops(self) -> int:
        t = self.traffic
        return len(self.calls) * self.counts.call_flops(self.as_run, t.batch_size, t.prompt, t.new)

    # ---- what the per-layer metrics read (measured when first asked) ----
    def _events(self, run) -> float:
        """Device ms from just before ``run()``'s work to just after it."""
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        run()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    @functools.cached_property
    def prefill_ms(self) -> list[float]:
        """CUDA-event ms of ``engine.prefill`` on the cell's batch, one a call."""
        batch = self.traffic.batch(0, warm=True)
        return [self._events(lambda: self.engine.prefill(batch))
                for _ in range(int(self.cell.check.get("prefill_reps", 10)))]

    @functools.cached_property
    def decode_step_ms(self) -> float | None:
        """CUDA-event ms of the cell's ``new - 1`` consecutive
        ``engine.decode`` steps on a state its prefill made, a step."""
        t = self.traffic
        if t.new < 2:
            return None
        last, state = self.engine.prefill(t.batch(0, warm=True))
        tokens = torch.argmax(last, dim=-1).to(torch.int32)

        def steps():
            nonlocal state
            for i in range(t.new - 1):
                _, state = self.engine.decode(state, tokens, t.prompt + i)

        return self._events(steps) / (t.new - 1)

    @functools.cached_property
    def prefill_trace(self) -> list:
        """The device events (name, start ns, end ns) of one profiled
        ``engine.prefill`` on the cell's batch."""
        batch = self.traffic.batch(0, warm=True)
        _sync(self.device)
        with _profile(self.device) as prof:
            self.engine.prefill(batch)
            _sync(self.device)
        return trace_events(prof)[0]

    @functools.cached_property
    def call_trace(self) -> dict:
        """``reduce_trace`` of a profiled stretch of whole ``generate`` calls
        (``trace_calls`` of them), the window its host annotation's span."""
        from torch.profiler import record_function

        t = self.traffic
        batches = [t.batch(i + 1, warm=True) for i in range(int(self.cell.check.get("trace_calls", 1)))]
        _sync(self.device)
        with _profile(self.device) as prof:
            with record_function("bench.calls"):
                for b in batches:
                    self.engine.generate(b, t.new).cpu()
        dev, host = trace_events(prof)
        (t0, t1), = [(a, b) for n, a, b in host if n == "bench.calls"]
        return reduce_trace(dev, host, t0, t1)

    # ---- the check ------------------------------------------------------
    def free_program(self) -> None:
        """Drop the engine (its graphs, pool and caches); the weights stay
        for the reference."""
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> dict[int, list[int]]:
        """The requests the check compares, drawn from the seed among those
        the window finished: {call: rows}."""
        every = [(c, r) for c in range(len(self.calls)) for r in range(self.traffic.batch_size)]
        rng = np.random.default_rng(sub_seed(self.seed, SAMPLE))
        n = min(int(self.cell.check["sample_requests"]), len(every))
        by_call: dict[int, list[int]] = {}
        for c, r in sorted(every[i] for i in rng.choice(len(every), n, replace=False)):
            by_call.setdefault(c, []).append(r)
        return by_call

    def blocks(self):
        """(call's batch, rows as a device tensor, their served tokens) in
        blocks of at most ``reference_rows`` rows: the reference's batches."""
        size = int(self.cell.check.get("reference_rows", 4))
        for c, rows in self.sample().items():
            batch = self.traffic.batch(c)
            for i in range(0, len(rows), size):
                sel = torch.tensor(rows[i : i + size])
                yield batch, sel.to(self.device), self.served[c][sel]

    def check(self) -> dict:
        """The sample's numbers (``numbers``), each that the cell's
        ``limits`` name held to its limit (``verdict``)."""
        per_token = [self.gaps(batch, sel, served).flatten().cpu()
                     for batch, sel, served in self.blocks()]
        got = numbers(torch.cat(per_token))
        correct, checked = verdict(got, self.cell.check["limits"])
        return {"correct": correct, "numbers": checked, "tokens_compared": got["tokens"],
                "also": {k: v for k, v in got.items() if k not in checked}}

    def inputs(self, batch: dict, sel: torch.Tensor, served: torch.Tensor) -> dict:
        """The reference's inputs for rows ``sel`` of a call: each prompt
        and its served tokens but the last, at the program's positions."""
        t = self.traffic
        served = served.to(self.device)
        return {"tokens": torch.cat([batch["tokens"][sel], served[:, :-1]], dim=1),
                "patch_embeds": batch["patch_embeds"][sel] if "patch_embeds" in batch else None,
                "positions": t.served_positions(len(sel)), "prompt": t.prompt}

    def reference_logits(self, batch: dict, sel: torch.Tensor, served: torch.Tensor,
                         quant=None) -> torch.Tensor:
        """(rows, new, V) float32 logits of the reference at the positions
        that produced the served tokens."""
        return self.reference.logits(self.as_run, self.weights, self.inputs(batch, sel, served),
                                     out_start=self.traffic.prompt - 1, quant=quant)

    def gaps(self, batch: dict, sel: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
        """(rows, new) gaps of the served tokens below the reference's best."""
        return gap(self.reference_logits(batch, sel, served), served.to(self.device))


def numbers(gaps: torch.Tensor) -> dict:
    """What a check can compare, from the served tokens' gaps: the widest
    (``max_gap``), the median, and the share of tokens that are the
    reference's greedy choice (``match_share``)."""
    g = gaps.double()
    return {"max_gap": float(g.max()), "median_gap": float(g.median()),
            "match_share": float((g <= 0).double().mean()), "tokens": g.numel()}


def verdict(got: dict, limits: dict) -> tuple[bool, dict]:
    """Whether ``got`` holds every limit (``{name: {"at_most": x}}`` or
    ``{name: {"at_least": x}}``), and each number so held beside its limit."""
    checked, correct = {}, True
    for name, rule in limits.items():
        op = "<=" if "at_most" in rule else ">="
        limit = float(rule["at_most"] if op == "<=" else rule["at_least"])
        correct = correct and (got[name] <= limit if op == "<=" else got[name] >= limit)
        checked[name] = {"value": got[name], "limit": limit, "rule": op}
    return correct, checked


def gap(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the best of its row."""
    got = torch.gather(logits, -1, tokens.long()[..., None])[..., 0]
    return logits.max(dim=-1).values - got


def run(cell, *, seed: int, seconds: float, trace: bool, device, t_start: float,
        per_layer: list[dict], end_to_end: list[dict]) -> dict:
    """One run of a serving cell: the result's fields but ``device``'s card
    name and count, which the caller adds."""
    r = ServeRun(cell, seed, seconds, device, t_start)
    r.setup()
    r.window()
    r.read_peak()
    metrics, extra = {}, {}
    chosen = per_layer if trace else end_to_end
    for m in chosen:
        value = cell.module("metrics", m["name"]).read(r)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if trace:
        ct = r.call_trace
        extra["device"] = {"busy_s": ct["busy_s"], "window_s": ct["window_s"]}
        extra["breakdown"] = {"device_ops": ct["device_ops"], "idle_gaps": ct["idle_gaps"]}
        r.read_peak()  # the traced measurements' too
    r.free_program()
    t0 = time.perf_counter()
    verdict = r.check()
    verdict["check_s"] = time.perf_counter() - t0
    return {"attempted": r.requests, "failed": 0, "metrics": metrics,
            "calls_s": [b - a for a, b in r.calls],
            "memory_peak_bytes": r.memory_peak_bytes, "verdict": verdict, **extra}

