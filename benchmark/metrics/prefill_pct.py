"""prefill_pct (model step): the device time of the program's ``prefill``
span (the bucket switch over the prefill blocks) over that of ``burst``,
in the window, from graphs captured with the program's tracing on. Nothing
is read where either span is absent."""

from benchmark.harness import span_share


def read(run):
    return span_share(run.program, "prefill")
