"""The allocator's peak reservation on the card over set-up and the window
(CUDA graph pools included), in GiB."""


def read(run):
    return run.memory_peak_bytes / 2**30 if run.memory_peak_bytes else None
