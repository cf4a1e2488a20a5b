"""The share of a profiled stretch of whole ``generate`` calls in which no
device operation runs, in %: 100 x (1 - the union of the device events'
intervals over the stretch's span)."""


def read(run):
    ct = run.call_trace
    return 100.0 * (1.0 - ct["busy_s"] / ct["window_s"])
