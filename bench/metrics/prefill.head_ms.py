"""The head's device ms a prefill: the program's ``head`` span (the final
norm and the head's product over every prompt position) in a captured
prefill, its median over ``prefill_reps`` traced ``engine.prefill`` calls
(``spans.py``)."""

import spans


def read(run):
    return spans.median(run, "prefill", "serve.prefill/head")
