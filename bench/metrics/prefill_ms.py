"""The median of CUDA-event ms around calls of the engine's captured prefill
on the cell's batch (``prefill_reps`` of them)."""

import statistics


def read(run):
    return statistics.median(run.prefill_ms)
