"""Edge inputs of the sampler's top-k select, made from a seed with numpy.

chip_smoke.py's [sample] edge checks hold the kernel to its plain version
on them; tests/test_torch_sampling.py (the plain sampler against JAX's)
and tests/test_torch_cuda_kernels.py (the kernel against the plain
sampler) use them too."""

import numpy as np


def edge_logits(kind, seed, B, V, temperature=1.0):
    """Float32 logits [B, V]: "ties", each row's 24 largest logits in pairs
    one ulp apart that the division by ``temperature`` merges into ties;
    "equal", every logit 0.5; "ninf", -inf but for 3 finite values a
    row."""
    rng = np.random.default_rng(seed)
    if kind == "equal":
        return np.full((B, V), 0.5, np.float32)
    if kind == "ninf":
        x = np.full((B, V), -np.inf, np.float32)
        cols = np.argsort(rng.random((B, V)), axis=1)[:, :3]
        x[np.arange(B)[:, None], cols] = rng.standard_normal((B, 3)) * 4
        return x
    assert kind == "ties", kind
    t = np.float32(temperature)
    x = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    # at T 3, c in [24, 32) has an ulp of 2^-19 and c / 3 in [8, 10.7) one
    # of 2^-20: c and its upper neighbour end up two thirds of an ulp
    # apart, and about a third of such pairs round to one float
    c = rng.uniform(24, 32, 256 * B).astype(np.float32)
    up = np.nextafter(c, np.float32(np.inf))
    c = np.unique(c[(c / t) == (up / t)])
    c = rng.permutation(c)[:12 * B].reshape(B, 12)
    pairs = np.concatenate([c, np.nextafter(c, np.float32(np.inf))], axis=1)
    cols = np.argsort(rng.random((B, V)), axis=1)[:, :24]
    x[np.arange(B)[:, None], cols] = pairs
    return x
