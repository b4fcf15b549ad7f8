"""logits_pct (model step): the device time of the program's ``logits``
span (the logits and the token choice of each decode round) over that of
``burst``, in the window. Nothing is read where either span is absent."""

from benchmark.harness import span_share


def read(run):
    return span_share(run.program, "logits")
