"""The one traffic generator: every mix is a data file that it reads.

Prompt lengths come from the mix's ``prompt_len`` group (``{"dist":
"uniform", "min": a, "max": b}``), token ids are uniform below the model's
EOF id, and an open loop's gaps between arrivals come from its
``arrival`` group (``{"process": "poisson", "rate_per_s": r}``): each
drawn independently from the seed, so that one seed always gives the same
requests at the same times, and another seed an independent draw.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, *stream])


def lengths(g: np.random.Generator, n: int, spec: dict) -> np.ndarray:
    """n prompt lengths of ``spec``, independent draws."""
    if spec["dist"] != "uniform":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return g.integers(spec["min"], spec["max"] + 1, n)


def prompts(g: np.random.Generator, lens: np.ndarray, eof: int) -> list:
    """Token lists of the given lengths, ids uniform in [0, eof)."""
    flat = g.integers(0, eof, int(lens.sum()))
    cuts = np.cumsum(lens)[:-1]
    return [p.tolist() for p in np.split(flat, cuts)]


def batch(seed: int, index: int, n: int, spec: dict, eof: int,
          stream: int = 1) -> list:
    """Batch ``index`` of a run's ``stream``: n prompts."""
    g = rng(seed, stream, index)
    return prompts(g, lengths(g, n, spec), eof)


def gaps(g: np.random.Generator, n: int, arrival: dict) -> np.ndarray:
    """n gaps between Poisson arrivals at ``rate_per_s``: independent
    exponential draws."""
    if arrival["process"] != "poisson":
        raise ValueError(f"unknown arrival process {arrival['process']!r}")
    return g.exponential(1.0 / arrival["rate_per_s"], n)


class Arrivals:
    """An open loop's requests in arrival order: ``take(t)`` returns the
    prompts of every request scheduled at or before ``t`` seconds after
    the start, with their scheduled times; blocks of ``block`` requests
    are drawn from the seed as they are needed."""

    def __init__(self, seed: int, traffic: dict, eof: int, stream: int = 2,
                 block: int = 1024):
        self.seed, self.traffic, self.eof = seed, traffic, eof
        self.stream, self.block = stream, block
        self.n_blocks = 0
        self.times = np.zeros(0)
        self.queue: list = []
        self.t_last = 0.0

    def _more(self) -> None:
        g = rng(self.seed, self.stream, self.n_blocks)
        self.n_blocks += 1
        t = self.t_last + np.cumsum(gaps(g, self.block,
                                         self.traffic["arrival"]))
        self.t_last = float(t[-1])
        self.times = np.concatenate([self.times, t])
        lens = lengths(g, self.block, self.traffic["prompt_len"])
        self.queue += prompts(g, lens, self.eof)

    def take(self, t: float) -> tuple:
        """(prompts, scheduled times) of the requests due by ``t``."""
        while self.t_last <= t:
            self._more()
        k = int(np.searchsorted(self.times, t, side="right"))
        out, when = self.queue[:k], self.times[:k]
        self.queue, self.times = self.queue[k:], self.times[k:]
        return out, when
