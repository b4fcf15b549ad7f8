"""host_syncs_per_burst.serve (session): the session's host syncs over its
bursts (StreamingSession.stats) while it served the window's requests.
Open loops only."""


def read(run):
    w = run.window
    if not w.get("bursts"):
        return None
    return w["host_syncs"] / w["bursts"]
