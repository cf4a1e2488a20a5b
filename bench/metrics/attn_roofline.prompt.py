"""Prefill attention's share of its roofline, in %: the least time one
launch could take on the card (the larger of its causal FLOPs over the bf16
peak and its bytes over the HBM bandwidth; ``counts.attention_launch``) over
the median device time of the attention kernels in a profiled prefill. The
kernels are picked by the name patterns of ``attention_kernels.txt``, so the
metric reads the same work whatever kernel does it. Nothing is returned
where no such kernel was seen or the card's peaks are unknown."""

import statistics
from pathlib import Path


def patterns() -> list[str]:
    text = (Path(__file__).with_name("attention_kernels.txt")).read_text()
    return [line.strip().lower() for line in text.splitlines()
            if line.strip() and not line.startswith("#")]


def is_attention(name: str) -> bool:
    low = name.lower()
    return any(p in low for p in patterns())


def read(run):
    times = [(b - a) * 1e-9 for n, a, b in run.prefill_trace if is_attention(n)]
    if not times or run.peak is None:
        return None
    t = run.traffic
    ops, n_bytes = run.counts.attention_launch(run.as_run, t.batch_size, t.prompt)
    bound = max(ops / run.peak["bf16_flops_s"], n_bytes / run.peak["hbm_bytes_s"])
    return 100.0 * bound / statistics.median(times)
