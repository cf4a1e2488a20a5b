"""The 95th percentile of every request's latency in the window, from its
call's start to its tokens on the host (host clock)."""

from common import quantile


def read(run):
    return 1e3 * quantile(run.latencies_s, 0.95)
