"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``. Prints the
set-up and capture counts, then the compared numbers with their limits, on
standard error, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (``--trace 0``: the
cell's end-to-end metrics; ``--trace 1``: its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and last ``check``.

Exits 1 without a result when CUDA is absent or has fewer cards than the
cell asks for, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the folder of this file shadows standard modules (``trace``); the
# harness is imported as the ``benchmark`` package from the root
sys.path[0] = ROOT
# a library that would load JAX by itself (transformers) must not
os.environ.setdefault("USE_FLAX", "0")
# one host thread for CPU-side tensor work: no pool of spinning workers
# beside the Python thread that drives the card
os.environ.setdefault("OMP_NUM_THREADS", "1")


def main(argv=None) -> int:
    from benchmark import harness, spec

    t_start = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(1)

    bench = spec.benchmark(ROOT)
    chips = spec.cell(bench, args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 1
    result, checks = harness.run(args.workload, args.seed, args.seconds,
                                 bool(args.trace), "cuda", bench, t_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 1
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
