"""The median device ms of the program's ``serve.decode`` span (the position,
the captured decode step's replay and its logits' copy) over the steps of
``trace_calls`` traced ``generate`` calls (``spans.py``)."""

import spans


def read(run):
    return spans.median(run, "generate", "serve.decode")
