"""moe_pct (model step): the device time of the program's ``moe`` span (the
expert layers of each decode round: gate, sort, grouped products, combine,
shared experts) over that of ``burst``, in the window. Nothing is read
where either span is absent (a model without routed experts, or a program
that has no such span)."""

from benchmark.harness import span_share


def read(run):
    return span_share(run.program, "moe")
