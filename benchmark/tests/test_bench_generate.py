"""The traffic generator: one seed gives the same requests at the same
times; another seed an independent draw of the same mix."""

from __future__ import annotations

import numpy as np

from benchmark import generate

SEED = 2**31 + 11
SPEC = {"dist": "uniform", "min": 16, "max": 128}
MIX = {"arrival": {"process": "poisson", "rate_per_s": 4000.0},
       "prompt_len": SPEC}


def test_batch_is_the_seeds():
    a = generate.batch(SEED, 3, 512, SPEC, 1000)
    assert a == generate.batch(SEED, 3, 512, SPEC, 1000)
    assert a != generate.batch(SEED + 1, 3, 512, SPEC, 1000)
    assert a != generate.batch(SEED, 4, 512, SPEC, 1000)
    lens = np.array([len(p) for p in a])
    assert lens.min() >= 16 and lens.max() <= 128
    assert max(max(p) for p in a) < 1000


def _arrivals(seed, t=2.0):
    arr = generate.Arrivals(seed, MIX, 1000)
    return arr.take(t)


def test_arrivals_are_a_poisson_process():
    prompts, when = _arrivals(SEED)
    again, when2 = _arrivals(SEED)
    assert prompts == again and np.array_equal(when, when2)
    other, when3 = _arrivals(SEED + 1)
    assert not np.array_equal(when[:100], when3[:100])
    # ~8000 arrivals in 2 s at 4000/s; the gaps' spread is the
    # exponential's (coefficient of variation 1), not an even schedule's
    assert abs(len(when) - 8000) < 5 * np.sqrt(8000)
    g = np.diff(when)
    assert 0.9 < g.std() / g.mean() < 1.1
    # two blocks of 1024 arrivals last different times: the rate swings
    blocks = [when[1023] - when[0], when[2047] - when[1024]]
    assert blocks[0] != blocks[1]
    assert all(16 <= len(p) <= 128 for p in prompts)


def test_take_hands_each_request_once():
    arr = generate.Arrivals(SEED, MIX, 1000)
    a, ta = arr.take(0.5)
    b, tb = arr.take(1.0)
    assert np.all(ta <= 0.5) and np.all((tb > 0.5) & (tb <= 1.0))
    whole, tw = _arrivals(SEED, 1.0)
    assert a + b == whole and np.array_equal(np.concatenate([ta, tb]), tw)
