"""Process start to the first timed call: weights, kernel loads (or builds),
graph capture and warm-up (host clock)."""


def read(run):
    return run.setup_s
