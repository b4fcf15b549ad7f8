"""device_idle_pct (device): the share of the traced stretch in which no
kernel, copy or set ran on the card (the union of their intervals from the
profiler's trace; overlaps count once)."""


def read(run):
    p = run.profile
    if not p or not p.get("window_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
