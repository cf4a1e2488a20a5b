"""Tokens generated by the window's calls over the window's seconds (host clock)."""


def read(run):
    return run.requests * run.traffic.new / run.window_s
