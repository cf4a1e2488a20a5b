"""Prompt positions (text and image) prefilled by the window's calls over the
window's seconds (host clock)."""


def read(run):
    return run.requests * run.traffic.prompt / run.window_s
