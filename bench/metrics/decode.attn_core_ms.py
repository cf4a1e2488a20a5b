"""Decode attention's device ms a step: the program's ``attn.core`` spans
(the cache write and the attention over the cache) summed over the layers
of a decode step, their median over the steps of ``trace_calls`` traced
``generate`` calls (``spans.py``)."""

import spans


def read(run):
    return spans.median(run, "generate", "serve.decode/attn.core")
