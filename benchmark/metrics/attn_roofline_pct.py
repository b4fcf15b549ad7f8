"""attn_roofline_pct (kernels): the least time of the decode attention of
the traced stretch's requests (roofline.attention_bound_s: the same work
whichever kernel implements it) over the device time of the attention
kernels in the trace, those whose name holds the configuration's
``attention.kernel``. Nothing is read where the trace holds no such
kernel."""

from benchmark.roofline import attention_bound_s


def read(run):
    p = run.profile
    if not p or "kernels" not in p:
        return None
    name = run.cfg["attention"]["kernel"]
    secs = sum(s for k, (_, s) in p["kernels"].items() if name in k)
    if secs <= 0:
        return None
    return 100.0 * attention_bound_s(run.cfg, p["requests"]) / secs
