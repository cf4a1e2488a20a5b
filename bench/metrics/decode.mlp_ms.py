"""The MLP's device ms a decode step: the program's ``mlp`` spans (``ln2``,
the MLP and the residual) summed over the layers of a decode step, their
median over the steps of ``trace_calls`` traced ``generate`` calls
(``spans.py``)."""

import spans


def read(run):
    return spans.median(run, "generate", "serve.decode/mlp")
