"""mla_pct (model step): the device time of the program's ``mla`` span (the
latent attention block of each decode round: projections, absorption, the
latent write, the decode kernel, W_UV and the output projection) over that
of ``burst``, in the window. Nothing is read where either span is absent
(a model without latent attention, or a program that has no such span)."""

from benchmark.harness import span_share


def read(run):
    return span_share(run.program, "mla")
