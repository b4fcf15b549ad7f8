"""moe_roofline_pct (kernels): the least time of the routed experts'
grouped products over the traced stretch (the ``moe_bound_s`` of the
configuration's ``arch``, given the stretch's requests and its expert-layer
calls) over the device time of the kernels the configuration's
``moe.kernels`` names, name for name. A call is two grouped products, so
the named kernels must launch exactly twice the calls the arch's
``moe_calls`` expects from the stretch's decode attention launches (the
``attention.kernels``) and its requests. Nothing is read where the
configuration names none, the trace holds none of them, or the launches
are not twice the expected calls (a tile configuration the list does not
name, say)."""

from benchmark import spec


def read(run):
    p = run.profile
    names = set(run.cfg.get("moe", {}).get("kernels", []))
    if not p or "kernels" not in p or not names:
        return None
    hits = [v for k, v in p["kernels"].items() if k in names]
    secs = sum(s for _, s in hits)
    launches = sum(n for n, _ in hits)
    attn = set(run.cfg["attention"]["kernels"])
    attn_calls = max((n for k, (n, _) in p["kernels"].items() if k in attn),
                     default=0)
    arch = spec.arch(run.cfg["arch"])
    calls = arch.moe_calls(run.cfg, p["requests"], attn_calls)
    if secs <= 0 or calls is None or launches != 2 * calls:
        return None
    return 100.0 * arch.moe_bound_s(run.cfg, p["requests"], calls) / secs
