"""Sampled decoding in the port against the JAX package, token for token.

The port draws JAX's own threefry bits (ops/random), so its plain
``sample_next_token`` and its sampling AutonomousEngine and
StreamingSession give the JAX package's tokens for the same seed on
float32 configs: the Gumbel noise differs from XLA's by the ulps of
``log`` and the logits by the ulps of the matmuls, which moves a token
only at a near-tie of the two best perturbed scores. The op tests below
check that no such near-tie occurs on their inputs, so a miss there is a
fault. The engine tests compare whole token streams (a near-tie would show
as a miss on one request and be investigated, not retried)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from min_llm_inference_tpu import EngineConfig as JEngineConfig
from min_llm_inference_tpu import ItemStorage as JItemStorage
from min_llm_inference_tpu import ModelConfig as JModelConfig
from min_llm_inference_tpu import Request as JRequest
from min_llm_inference_tpu import init_params
from min_llm_inference_tpu.ops import reference as jr
from min_llm_inference_tpu.runtime.autonomous import (
    AutonomousEngine as JAutonomousEngine,
)
from min_llm_inference_tpu.runtime.autonomous import (
    StreamingSession as JStreamingSession,
)
import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch.ops import random as trand
from min_llm_inference_tpu_torch.ops import reference as tref
from min_llm_inference_tpu_torch.ops import sampling as tsamp
from min_llm_inference_tpu_torch.tools.sampling_edges import edge_logits

torch.set_num_threads(1)

MODEL = JModelConfig(n_vocab=256, emb_dim=32, n_seq=64, eof_token_id=255)
TMODEL = T.ModelConfig(**dataclasses.asdict(MODEL))
SAMPLING = dict(temperature=1.5, top_k=16, sample_seed=7)


def tkey(jkey):
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def op_inputs(seed, B, V):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    lengths = rng.integers(0, 12, B).astype(np.int32)
    lengths[0], lengths[1] = 0, 11          # a dead row, one at n_seq - 1
    return logits, lengths


def assert_no_near_tie(logits, key, temperature, top_k, rel=1e-5):
    """The two best perturbed scores of every row (JAX's arithmetic) are
    apart by more than ``rel`` of their size."""
    scaled = jnp.asarray(logits) / jnp.maximum(temperature, 1e-6)
    if top_k and top_k < logits.shape[-1]:
        kth = jax.lax.top_k(scaled, top_k)[0][..., -1:]
        scaled = jnp.where(scaled >= kth, scaled, -jnp.inf)
    pert = np.asarray(jax.random.gumbel(key, logits.shape) + scaled)
    top2 = np.sort(pert, axis=-1)[:, -2:]
    gap = (top2[:, 1] - top2[:, 0]) / np.maximum(np.abs(top2[:, 1]), 1.0)
    assert (gap > rel).all(), gap.min()


@pytest.mark.parametrize("temperature", [0.7, 1.5])
@pytest.mark.parametrize("top_k", [0, 1, 16, "V"])
@pytest.mark.parametrize("B, V", [(16, 1024), (3, 50257)])
def test_sample_next_token_matches_jax(temperature, top_k, B, V):
    k = V if top_k == "V" else top_k
    logits, lengths = op_inputs(B + V + k, B, V)
    key = jax.random.PRNGKey(V + k)
    assert_no_near_tie(logits, key, temperature, k)
    wt, wl = jr.sample_next_token(jnp.asarray(logits), jnp.asarray(lengths),
                                  12, 5, key, temperature, k)
    gt, gl = tref.sample_next_token(torch.from_numpy(logits),
                                    torch.from_numpy(lengths), 12, 5,
                                    tkey(key), temperature, k)
    assert gt.dtype == gl.dtype == torch.int32
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert gt[0] == T.EMPTY_ROW_TOKEN_ID and gl[0] == 0 and gl[1] == 0


def test_top_k_keeps_ties_at_the_threshold():
    """Every value equal to the k-th largest stays in (``>=``), as in
    JAX: with top_k=2 and three equal maxima all three can be drawn."""
    logits = np.zeros((64, 8), np.float32)
    logits[:, 2] = logits[:, 5] = logits[:, 6] = 4.0
    lengths = np.full(64, 3, np.int32)
    key = jax.random.PRNGKey(1)
    wt, _ = jr.sample_next_token(jnp.asarray(logits), jnp.asarray(lengths),
                                 64, 7, key, 1.0, 2)
    gt, _ = tref.sample_next_token(torch.from_numpy(logits),
                                   torch.from_numpy(lengths), 64, 7,
                                   tkey(key), 1.0, 2)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    assert set(gt.tolist()) == {2, 5, 6}


def assert_plain_matches_jax(logits, lengths, key, temperature, top_k):
    """The port's plain sampler gives JAX's tokens and lengths on these
    inputs, whose two best perturbed scores are no near-tie."""
    assert_no_near_tie(logits, key, temperature, top_k)
    wt, wl = jr.sample_next_token(jnp.asarray(logits), jnp.asarray(lengths),
                                  12, 5, key, temperature, top_k)
    gt, gl = tref.sample_next_token(torch.from_numpy(logits),
                                    torch.from_numpy(lengths), 12, 5,
                                    tkey(key), temperature, top_k)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    return gt


@pytest.mark.parametrize("kind,temperature,top_k", [
    ("ties", 3.0, 3), ("ties", 3.0, 15), ("equal", 1.0, 0),
    ("equal", 1.0, 16), ("ninf", 1.0, 0), ("ninf", 1.0, 2),
    ("ninf", 1.0, 16)])
def test_sample_edges_match_jax(kind, temperature, top_k):
    """Edges of the top-k select: pairs one ulp apart that the division by
    T = 3 merges (an odd top_k puts the k-th value on a merged pair, whose
    partner stays in: one more kept element than top_k, where a filter on
    the raw logits would keep top_k), all-equal rows (every element kept),
    rows of -inf with 3 finite values (the k-th value -inf for top_k 16)."""
    B, V = 16, 1024
    logits = edge_logits(kind, 11 + top_k, B, V, temperature)
    lengths = op_inputs(3, B, V)[1]
    key = jax.random.PRNGKey(top_k + 3)
    if kind == "ties":
        scaled = jnp.asarray(logits) / jnp.float32(temperature)
        kth = jax.lax.top_k(scaled, top_k)[0][:, -1:]
        assert (np.asarray((scaled >= kth).sum(axis=-1)) == top_k + 1).all()
        raw_kth = np.sort(logits, axis=-1)[:, -top_k][:, None]
        assert ((logits >= raw_kth).sum(axis=-1) == top_k).all()
    tok = assert_plain_matches_jax(logits, lengths, key, temperature, top_k)
    live = lengths > 0
    assert np.isfinite(logits[live, tok.numpy()[live]]).all()


# (V, top_k): top_k on each side of a warp's 32 lanes and V - 1 at widths
# not a multiple of 32; top_k 1 and V - 1 on rows narrower than a warp
AWKWARD_TOP_K = [pytest.param(V, k, id=f"{k}-{V}")
                 for k in (31, 32, 33, "V-1") for V in (1000, 1023)] + [
    pytest.param(V, k, id=f"{k}-{V}") for V in (7, 31) for k in (1, "V-1")]


@pytest.mark.parametrize("V,top_k", AWKWARD_TOP_K)
def test_awkward_top_k_match_jax(V, top_k):
    """Awkward top_k values and widths (AWKWARD_TOP_K)."""
    k = V - 1 if top_k == "V-1" else top_k
    logits, lengths = op_inputs(V + k, 16, V)
    assert_plain_matches_jax(logits, lengths, jax.random.PRNGKey(k), 1.5, k)


@pytest.mark.parametrize("top_k", [0, 16])
def test_wrapper_is_the_burst_round(top_k):
    """ops/sampling on CPU tensors: the JAX round, ``key, sub =
    split(key)`` then the draw with ``sub``; the next key is returned."""
    logits, lengths = op_inputs(4, 16, 1024)
    jkey = jax.random.PRNGKey(9)
    jnext, jsub = jax.random.split(jkey)
    wt, wl = jr.sample_next_token(jnp.asarray(logits), jnp.asarray(lengths),
                                  12, 5, jsub, 0.7, top_k)
    gt, gl, gnext = tsamp.sample_next_token(
        torch.from_numpy(logits), torch.from_numpy(lengths), tkey(jkey),
        n_seq=12, eof_token_id=5, temperature=0.7, top_k=top_k)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gnext.numpy(), np.asarray(jnext))


def test_wrapper_rejects_what_it_does_not_take():
    logits, lengths = op_inputs(5, 4, 64)
    args = (torch.from_numpy(logits), torch.from_numpy(lengths),
            trand.prng_key(0))
    with pytest.raises(ValueError, match="temperature"):
        tsamp.sample_next_token(*args, n_seq=12, eof_token_id=5,
                                temperature=0.0)
    with pytest.raises(ValueError, match="bits_out"):
        tsamp.sample_next_token(*args, n_seq=12, eof_token_id=5,
                                temperature=1.0,
                                bits_out=torch.zeros(4, 64, dtype=torch.int32))
    with pytest.raises(ValueError, match="float32"):
        tsamp.sample_next_token(args[0].double(), *args[1:], n_seq=12,
                                eof_token_id=5, temperature=1.0)


# ---------------------------------------------------------------- engines


def params_for(eof_bias):
    jparams = init_params(jax.random.PRNGKey(0), MODEL, eof_bias=eof_bias)
    tparams = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                  TMODEL, device="cpu")
    return jparams, tparams


@pytest.fixture(scope="module")
def params():
    return params_for(0.05)


@pytest.fixture(scope="module")
def params_long():
    """No EOF bias: sampled requests mostly run to n_seq, so a tight
    overcommit pool must preempt."""
    return params_for(0.0)


def prompts_for(seed, n, max_len=23):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MODEL.eof_token_id,
                         int(rng.integers(1, max_len + 1))).tolist()
            for _ in range(n)]


def run_jax(jparams, cfg, prompts, **engine_kw):
    store = JItemStorage()
    for i, p in enumerate(prompts):
        store.add_new_item(JRequest(i, list(p)))
    JAutonomousEngine(jparams, MODEL, cfg, attention_impl="jnp",
                      **engine_kw).run(store)
    return {i: r.tokens for i, r in store.finished.items()}


def run_port(tparams, cfg, prompts, **engine_kw):
    store = T.ItemStorage()
    for i, p in enumerate(prompts):
        store.add_new_item(T.Request(i, list(p)))
    eng = T.AutonomousEngine(tparams, TMODEL,
                             T.EngineConfig(**dataclasses.asdict(cfg)),
                             attention_impl="grouped", device="cpu",
                             **engine_kw)
    eng.run(store)
    return {i: r.tokens for i, r in store.finished.items()}, eng


CONFIGS = {
    "no-ring": dict(decode_ring=False),
    "no-ring-subbursts-int8": dict(decode_ring=False, subbursts=2,
                                   kv_dtype="int8"),
    "ring-dgrid": dict(decode_ring=True, attn_dgrid=True, sort_admits=True),
    "ring-subbursts-int8": dict(decode_ring=True, subbursts=2,
                                kv_dtype="int8"),
    "overcommit": dict(decode_ring=False, overcommit=True, n_pages=8,
                       kv_dtype="int8"),
    "overcommit-ring": dict(decode_ring=True, overcommit=True, n_pages=8),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sampling_engine_matches_jax(params, params_long, name):
    """temperature=1.5, top_k=16, seed 7: every request's tokens equal the
    JAX engine's; 14 requests over 8 slots, so slots turn over."""
    kw = CONFIGS[name]
    jparams, tparams = params_long if kw.get("overcommit") else params
    cfg = JEngineConfig(**{**dict(n_slots=8, page_size=16, n_pages=32,
                                  n_forward_rounds=4), **kw})
    prompts = prompts_for(len(name), 14)
    want = run_jax(jparams, cfg, prompts, **SAMPLING)
    got, eng = run_port(tparams, cfg, prompts, **SAMPLING)
    assert len(got) == len(prompts)
    assert got == want
    if kw.get("overcommit"):
        assert eng.stats.preemptions > 0
    # one split per executed round, none in a burst the gate skipped
    executed = eng.stats.bursts - eng.stats.skipped
    assert eng.stats.rounds == executed * cfg.n_forward_rounds


def test_sampling_drain_downshift_matches_jax(params):
    """The key rides across executed widths (16 slots, then 8)."""
    jparams, tparams = params
    cfg = JEngineConfig(n_slots=16, page_size=16, n_pages=64,
                        n_forward_rounds=4, decode_ring=False)
    prompts = prompts_for(11, 20)
    kw = dict(SAMPLING, min_drain_slots=8, bursts_per_chunk=1)
    want = run_jax(jparams, cfg, prompts, **kw)
    got, _ = run_port(tparams, cfg, prompts, **kw)
    assert got == want


def test_autonomous_sampling_deterministic_per_seed(params):
    """Mirror of test_autonomous.py::test_autonomous_sampling_deterministic
    _per_seed: same seed -> identical outputs, another seed -> different;
    the length rules unchanged."""
    _, tparams = params
    cfg = JEngineConfig(n_slots=8, page_size=16, n_pages=32,
                        n_forward_rounds=2)
    prompts = prompts_for(12, 12)

    def run(seed):
        return run_port(tparams, cfg, prompts,
                        **dict(SAMPLING, sample_seed=seed))[0]

    a, b, c = run(7), run(7), run(8)
    assert len(a) == 12 and a == b
    for toks in a.values():
        assert len(toks) <= MODEL.n_seq
        assert all(0 <= t < MODEL.n_vocab for t in toks)
    assert a != c, "different seeds produced identical streams"


def test_same_engine_reruns_from_its_seed(params):
    """A second run() of one engine starts again from the seed's key."""
    _, tparams = params
    cfg = T.EngineConfig(n_slots=8, page_size=16, n_pages=32,
                         n_forward_rounds=2, decode_ring=False)
    eng = T.AutonomousEngine(tparams, TMODEL, cfg, device="cpu", **SAMPLING)
    outs = []
    for _ in range(2):
        store = T.ItemStorage()
        for i, p in enumerate(prompts_for(13, 10)):
            store.add_new_item(T.Request(i, list(p)))
        eng.run(store)
        outs.append({i: r.tokens for i, r in store.finished.items()})
    assert outs[0] == outs[1]


def jax_session(jparams, cfg, prompts, split_at, seed):
    eng = JAutonomousEngine(jparams, MODEL, cfg, attention_impl="jnp",
                            **dict(SAMPLING, sample_seed=seed),
                            max_new_per_burst=4, bursts_per_chunk=2)
    sess = JStreamingSession(eng, capacity=len(prompts), max_prompt_len=32)
    sess.submit([JRequest(i, list(prompts[i])) for i in range(split_at)])
    sess.step()
    sess.submit([JRequest(i, list(prompts[i]))
                 for i in range(split_at, len(prompts))])
    return {r.id: r.tokens for r in sess.close()}


def port_session(tparams, cfg, prompts, split_at, seed):
    eng = T.AutonomousEngine(tparams, TMODEL,
                             T.EngineConfig(**dataclasses.asdict(cfg)),
                             device="cpu", **dict(SAMPLING, sample_seed=seed),
                             max_new_per_burst=4, bursts_per_chunk=2)
    sess = T.StreamingSession(eng, capacity=len(prompts), max_prompt_len=32)
    sess.submit([T.Request(i, list(prompts[i])) for i in range(split_at)])
    sess.step()
    sess.submit([T.Request(i, list(prompts[i]))
                 for i in range(split_at, len(prompts))])
    return {r.id: r.tokens for r in sess.close()}


@pytest.mark.parametrize("kw", [dict(), dict(kv_dtype="int8", subbursts=2),
                                dict(overcommit=True, n_pages=8)],
                         ids=["f32", "int8-subbursts", "overcommit"])
def test_sampling_session_matches_jax_session(params, params_long, kw):
    """StreamingSession with JAX's submission pattern (4 requests, a
    step, the rest, close) gives the JAX session's tokens."""
    jparams, tparams = params_long if kw.get("overcommit") else params
    cfg = JEngineConfig(**{**dict(n_slots=8, page_size=16, n_pages=32,
                                  n_forward_rounds=2, decode_ring=False),
                           **kw})
    prompts = prompts_for(21, 10)
    want = jax_session(jparams, cfg, prompts, 4, 7)
    got = port_session(tparams, cfg, prompts, 4, 7)
    assert len(got) == 10 and got == want


def test_streaming_session_sampling_same_pattern_same_seed(params):
    """Mirror of test_autonomous.py::test_streaming_session_sampling_same
    _pattern_same_seed: reproducible for a fixed (seed, submission
    pattern), and another seed differs."""
    _, tparams = params
    cfg = JEngineConfig(n_slots=8, page_size=16, n_pages=32,
                        n_forward_rounds=2)
    prompts = prompts_for(22, 10)
    a = port_session(tparams, cfg, prompts, 4, 3)
    b = port_session(tparams, cfg, prompts, 4, 3)
    c = port_session(tparams, cfg, prompts, 4, 4)
    assert len(a) == 10
    assert a == b, "same seed + same pattern must reproduce exactly"
    assert a != c, "different seeds produced identical streams"
