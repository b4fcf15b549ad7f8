"""ring_pct (model step): the device time of the program's ``ring`` span
(the ring's write, merge, pack and flush) over that of ``burst``, in the
window. Nothing is read where the ring is off or a span is absent."""

from benchmark.harness import span_share


def read(run):
    return span_share(run.program, "ring")
