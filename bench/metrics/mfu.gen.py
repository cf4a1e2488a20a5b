"""The whole step's share of the card's bf16 peak, in %: the model FLOPs of
the window's calls (``counts.call_flops``: 2 x the active parameters a
position, the routed top-k experts only, the causal score and value
products, and the head once a generated token) over the window's seconds
times the peak."""


def read(run):
    if run.peak is None:
        return None
    return 100.0 * run.window_flops / (run.window_s * run.peak["bf16_flops_s"])
