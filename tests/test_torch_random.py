"""The port's threefry random numbers (ops/random) and ``init_params``
against JAX's on the CPU.

Keys, split, bits and uniform draws must be bit-equal to ``jax.random``'s
(threefry2x32, ``jax_threefry_partitionable=True``, 64-bit mode off), and
``init_params`` leaves bit-equal to the JAX package's for float32 and
bfloat16. Gumbel draws are ``-log(-log(u))`` of a bit-equal ``u``: XLA's CPU
``log`` differs from PyTorch's (correctly rounded) one by an ulp on ~14%
of inputs, so they agree within 2e-6 absolute, not bit for bit."""

import dataclasses
import sys
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from min_llm_inference_tpu import ModelConfig as JModelConfig
from min_llm_inference_tpu import init_params as jinit
import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch.models.params import params_checksum
from min_llm_inference_tpu_torch.ops import random as tr

SEEDS = [0, 7, 2**31 - 1]
SHAPES = [(7, 50257), (3, 5, 11), (1,)]
TINY = float(jnp.finfo(jnp.float32).tiny)


def tkey(jkey):
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def as_bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("key, counter, want", [
    # Random123's known-answer vectors for Threefry-2x32, 20 rounds
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(key, counter, want):
    x0, x1 = tr.threefry2x32(torch.tensor(key, dtype=torch.int64),
                             torch.tensor([counter[0]]),
                             torch.tensor([counter[1]]))
    assert (int(x0), int(x1)) == want


@pytest.mark.parametrize("seed", SEEDS + [-1, 2**32 + 5])
def test_prng_key_and_split_bit_equal(seed):
    jkey = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(tr.prng_key(seed).numpy(),
                                  np.asarray(jkey).astype(np.int64))
    for n in (2, 3, 17):
        np.testing.assert_array_equal(
            tr.split(tkey(jkey), n).numpy(),
            np.asarray(jax.random.split(jkey, n)).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_chain_bit_equal(seed):
    """The burst's carry: ``key, sub = split(key)`` round after round."""
    jkey, key = jax.random.PRNGKey(seed), tr.prng_key(seed)
    for _ in range(6):
        jkey, jsub = jax.random.split(jkey)
        key, sub = tr.split(key)
        np.testing.assert_array_equal(sub.numpy(), np.asarray(jsub))
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_bit_equal(seed, shape):
    jkey = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        tr.random_bits(tkey(jkey), shape).numpy(),
        np.asarray(jax.random.bits(jkey, shape)).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lo, hi", [(0.0, 1.0), (-1.0, 1.0), (TINY, 1.0),
                                    (0.3, 1.7), (-5.0, 3.0)])
def test_uniform_bit_equal(seed, shape, lo, hi):
    jkey = jax.random.PRNGKey(seed)
    want = jax.random.uniform(jkey, shape, jnp.float32, lo, hi)
    got = tr.uniform(tkey(jkey), shape, lo, hi)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(as_bits(got.numpy()), as_bits(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel_matches(seed, shape):
    jkey = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.gumbel(jkey, shape))
    got = tr.gumbel(tkey(jkey), shape).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


REF = JModelConfig(n_vocab=256, emb_dim=32, n_seq=64, eof_token_id=255)
GPT2S_SHAPED = JModelConfig(n_vocab=2048, emb_dim=96, n_seq=64, n_layers=2,
                            n_heads=12, ffn_dim=384, use_output_proj=True,
                            use_layernorm=True, eof_token_id=1023)


@pytest.mark.parametrize("model", [REF, GPT2S_SHAPED], ids=["ref", "gpt2s2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed, eof_bias", [(0, 0.0), (3, 0.05)])
def test_init_params_bit_equal(model, dtype, seed, eof_bias):
    jm = dataclasses.replace(model, dtype=dtype)
    tm = T.ModelConfig(**dataclasses.asdict(jm))
    want = jinit(jax.random.PRNGKey(seed), jm, eof_bias=eof_bias)
    got = T.init_params(seed, tm, eof_bias=eof_bias, device="cpu")
    want_leaves = jax.tree_util.tree_leaves(want)
    got_leaves = jax.tree_util.tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == tm.torch_dtype
        np.testing.assert_array_equal(as_bits(g.float().numpy()),
                                      as_bits(np.asarray(w, np.float32)))
    # a key works as the seed does
    again = T.init_params(tkey(jax.random.PRNGKey(seed)), tm,
                          eof_bias=eof_bias, device="cpu")
    bridged = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, want),
                                  tm, device="cpu")
    assert params_checksum(again) == params_checksum(bridged)


def test_gpt2s_init_checksum_is_jax():
    """The checksum chip_smoke.py holds the card's ``init_params(0,
    gpt2s)`` to is the one of JAX's ``init_params(PRNGKey(0), ...)`` for
    bench.py's gpt2s model (the port bench's gpt2s_model()), computed here
    on the CPU."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    from min_llm_inference_tpu_torch.bench import gpt2s_model

    model = JModelConfig(**dataclasses.asdict(gpt2s_model()))
    want = jinit(jax.random.PRNGKey(0), model)
    tree = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, want),
                               T.ModelConfig(**dataclasses.asdict(model)),
                               device="cpu")
    assert params_checksum(tree) == chip_smoke.GPT2S_INIT_SHA256
