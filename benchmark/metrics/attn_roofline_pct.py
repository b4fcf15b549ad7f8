"""attn_roofline_pct (kernels): the least time of the decode attention of
the traced stretch's requests (the ``attention_bound_s`` of the
configuration's ``arch``: the same work whichever kernel implements it)
over the device time of the decode attention kernels in the trace, those
whose names the configuration's ``attention.kernels`` lists, name for
name. Nothing is read where the trace holds none of them."""

from benchmark import spec


def read(run):
    p = run.profile
    if not p or "kernels" not in p:
        return None
    names = set(run.cfg["attention"]["kernels"])
    secs = sum(s for k, (_, s) in p["kernels"].items() if k in names)
    if secs <= 0:
        return None
    bound = spec.arch(run.cfg["arch"]).attention_bound_s
    return 100.0 * bound(run.cfg, p["requests"]) / secs
