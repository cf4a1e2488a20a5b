"""CUDA-event ms over the cell's consecutive captured decode steps on a state
its prefill made, divided by their number."""


def read(run):
    return run.decode_step_ms
