"""The median device ms of the program's ``serve.prefill`` span (the batch to
the device, the captured prefill's replay and its logits' copy) over
``prefill_reps`` traced ``engine.prefill`` calls on the cell's batch
(``spans.py``)."""

import spans


def read(run):
    return spans.median(run, "prefill", "serve.prefill")
