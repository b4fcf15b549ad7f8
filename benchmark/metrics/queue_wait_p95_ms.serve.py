"""queue_wait_p95_ms.serve (session): the 95th percentile of the window's
admission waits, from each request's submit to the status read that shows
it admitted (the program's ``ThroughputCounter.ttfts``, host clock). Open
loops: a batch loop resets the counter at every batch."""

import numpy as np


def read(run):
    waits = (run.program or {}).get("ttfts")
    if not waits:
        return None
    return float(np.quantile(waits, 0.95)) * 1e3
