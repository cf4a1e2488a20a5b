"""The routed experts' device ms a decode step: the program's ``moe.experts``
spans (dispatch to combine) summed over the MoE layers of a decode step,
their median over the steps of ``trace_calls`` traced ``generate`` calls
(``spans.py``)."""

import spans


def read(run):
    return spans.median(run, "generate", "serve.decode/moe.experts")
