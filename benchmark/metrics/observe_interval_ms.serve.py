"""observe_interval_ms.serve (session): the mean time between the client's
status reads in the window (the harness's spans around
StreamingSession.step). Open loops only."""

import numpy as np


def read(run):
    reads = run.window.get("reads")
    if not reads or len(reads) < 2:
        return None
    return float(np.mean(np.diff(reads))) * 1e3
