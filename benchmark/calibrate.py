"""Readings that set the benchmark's limits and rates, made on the card.
The benchmark's own runs never run this.

    python3 benchmark/calibrate.py gaps --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...] [--out FILE]
    python3 benchmark/calibrate.py knee --workload <name> --seconds <s> \\
        --rates <r> [<r> ...] [--seed <n>] [--out FILE]

``gaps``: one whole run of the cell per seed in this process, each with
the control judged beside the program by the same checks: per seed, the
program's ``gap_sd`` and ``correct``, the control's (the plain reference
at float8 weights), the tokens compared and the run's metrics. The limit
lies between the program's largest reading and the control's smallest;
the command exits 1 where the control comes out correct on any seed.

``knee``: one set-up of an open-loop cell, then a window at each rate in
turn: the queue of requests not yet admitted at each status read (its
mean over the first and the last third of the window), the latency
percentiles and the requests left unfinished. The knee is the highest rate
whose queue does not grow across the window.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def gaps(args) -> tuple:
    from benchmark import harness
    out = []
    for seed in args.seeds:
        res, _ = harness.run(args.workload, seed, args.seconds, False,
                             "cuda", control=True)
        ctl = res["control"]
        rec = {"seed": seed, "gap_sd": res["check"]["gap_sd"]["value"],
               "control_gap_sd": ctl["check"]["gap_sd"]["value"],
               "served_tokens_compared": ctl["served_tokens"],
               "correct": res["correct"], "control_correct": ctl["correct"],
               "metrics": res["metrics"],
               "memory_peak_bytes": res["device"]["memory_peak_bytes"]}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    # the control has to come out not correct on every seed
    bad = [r["seed"] for r in out if r["control_correct"]]
    if bad:
        print(f"control came out correct on seeds {bad}", file=sys.stderr)
    return out, not bad


def knee(args) -> tuple:
    import numpy as np
    import torch

    from benchmark import harness, spec
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(cell["config"])
    base = spec.traffic(cell["traffic"])
    h, loop = harness.prepare(cell, cfg, base, args.seed,
                              torch.device("cuda"))
    out = []
    for rate in args.rates:
        h.traffic = copy.deepcopy(base)
        h.traffic["arrival"]["rate_per_s"] = rate
        w = loop.window(h, args.seconds)
        q = np.asarray(w["queued"], dtype=float)
        third = max(1, len(q) // 3)
        lat = np.asarray(w["latencies"]) * 1e3
        rec = {"rate_per_s": rate, "attempted": w["attempted"],
               "failed": w["failed"],
               "queued_first_third": float(q[:third].mean()),
               "queued_last_third": float(q[-third:].mean()),
               "p50_ms": float(np.quantile(lat, 0.5)),
               "p95_ms": float(np.quantile(lat, 0.95)),
               "served_per_s": (w["attempted"] - w["failed"])
               / args.seconds}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out, True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("gaps", "knee"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", type=float, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    out, ok = gaps(args) if args.mode == "gaps" else knee(args)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
