"""latency_p50_ms: the median latency of the requests that arrived in the
window, from each request's scheduled arrival to the status read that saw
it finish (host clock). Open loops only."""

import numpy as np


def read(run):
    lat = run.window.get("latencies")
    if not lat:
        return None
    return float(np.quantile(lat, 0.50)) * 1e3
