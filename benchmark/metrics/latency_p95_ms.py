"""latency_p95_ms: the 95th percentile of the latencies that
latency_p50_ms reads. Open loops only."""

import numpy as np


def read(run):
    lat = run.window.get("latencies")
    if not lat:
        return None
    return float(np.quantile(lat, 0.95)) * 1e3
