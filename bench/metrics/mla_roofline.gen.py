"""Latent decode attention's share of its roofline, in %: the least time one
launch could take on the card (the larger of its FLOPs over the bf16 peak
and its bytes over the HBM bandwidth; ``counts.mla_decode_launch`` at the
step's fill) over the device time of a launch in one profiled
``engine.decode`` step at fill prompt + new / 2: the summed time of the
kernels that the name patterns of ``mla_kernels.txt`` pick (so the metric
reads the same work whatever kernels do it, a split-K merge included),
over the layers, one launch each.  The step is profiled on first use and
cached on the run.  Nothing is returned without a card, where no such
kernel was seen or the card's peaks are unknown."""

from pathlib import Path

from common import trace_events

_KEY = "_bench_mla_step"


def patterns() -> list[str]:
    text = (Path(__file__).with_name("mla_kernels.txt")).read_text()
    return [line.strip().lower() for line in text.splitlines()
            if line.strip() and not line.startswith("#")]


def is_mla(name: str) -> bool:
    low = name.lower()
    return any(p in low for p in patterns())


def step_trace(run) -> tuple[int, list] | None:
    """(fill, the device events of one profiled decode step at that fill)."""
    if _KEY not in run.__dict__:
        run.__dict__[_KEY] = _measure(run) if run.device.type == "cuda" else None
    return run.__dict__[_KEY]


def _measure(run) -> tuple[int, list]:
    import torch
    from torch.profiler import ProfilerActivity, profile

    t = run.traffic
    fill = t.prompt + t.new // 2
    last, state = run.engine.prefill(t.batch(0, warm=True))
    tokens = torch.argmax(last, dim=-1).to(torch.int32)
    _, state = run.engine.decode(state, tokens, fill - 1)  # the step sees fill keys
    torch.cuda.synchronize(run.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run.engine.decode(state, tokens, fill - 1)
        torch.cuda.synchronize(run.device)
    return fill, trace_events(prof)[0]


def read(run):
    got = step_trace(run)
    if got is None or run.peak is None:
        return None
    fill, dev = got
    seconds = sum((b - a) * 1e-9 for n, a, b in dev if is_mla(n))
    if not seconds:
        return None
    ops, n_bytes = run.counts.mla_decode_launch(run.as_run, run.traffic.batch_size, fill)
    bound = max(ops / run.peak["bf16_flops_s"], n_bytes / run.peak["hbm_bytes_s"])
    return 100.0 * bound / (seconds / run.as_run["n_layers"])
