"""The port's StreamingSession against the JAX package, token for token.

Mirrors the streaming cases of test_autonomous.py and
test_overcommit.py::test_overcommit_streaming_session_token_exact: requests
submitted in waves while the engine runs (chunked, pipelined and fused
observation, rows recycled mod capacity, full grant and overcommit, f32 and
int8 KV) come out equal to the JAX package's one-shot AutonomousEngine on
the same prompts (its gather oracle "jnp"; the JAX tests hold its kernel
paths and its own StreamingSession equal to it). Parameters come from the
JAX ``init_params`` through numpy; the port runs its kernel path
("grouped", whose wrappers take the plain versions on CPU tensors)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from min_llm_inference_tpu import EngineConfig as JEngineConfig
from min_llm_inference_tpu import ItemStorage as JItemStorage
from min_llm_inference_tpu import ModelConfig as JModelConfig
from min_llm_inference_tpu import Request as JRequest
from min_llm_inference_tpu import init_params
from min_llm_inference_tpu.runtime.autonomous import (
    AutonomousEngine as JAutonomousEngine,
)
import min_llm_inference_tpu_torch as T

# tiny CPU tensors: PyTorch's intra-op threads would only contend with the
# other pytest-xdist workers, one per core
torch.set_num_threads(1)

MODEL = JModelConfig(n_vocab=256, emb_dim=32, n_seq=64, eof_token_id=255)
BASE = dict(n_slots=8, page_size=16, n_pages=32, n_forward_rounds=2)


def params_for(model, seed, **kw):
    jparams = init_params(jax.random.PRNGKey(seed), model, **kw)
    tparams = T.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams),
        T.ModelConfig(**dataclasses.asdict(model)), device="cpu")
    return jparams, tparams


@pytest.fixture(scope="module")
def params():
    return params_for(MODEL, 0, eof_bias=0.05)


def prompts_for(seed, n, model=MODEL, max_len=23):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, model.eof_token_id,
                         int(rng.integers(1, max_len + 1))).tolist()
            for _ in range(n)]


def jax_oneshot(jparams, cfg, prompts, model=MODEL):
    """The JAX package's one-shot engine: {request id: tokens}."""
    store = JItemStorage()
    for i, p in enumerate(prompts):
        store.add_new_item(JRequest(i, list(p)))
    JAutonomousEngine(jparams, model, cfg, attention_impl="jnp").run(store)
    return {i: r.tokens for i, r in store.finished.items()}


def session(tparams, cfg, capacity, max_prompt_len=32, model=MODEL,
            observe_lag=2, **engine_kw):
    eng = T.AutonomousEngine(tparams, T.ModelConfig(**dataclasses.asdict(
        model)), T.EngineConfig(**dataclasses.asdict(cfg)),
        attention_impl="grouped", device="cpu", **engine_kw)
    return T.StreamingSession(eng, capacity=capacity,
                              max_prompt_len=max_prompt_len,
                              observe_lag=observe_lag)


def reqs(prompts, lo, hi):
    return [T.Request(i, list(prompts[i])) for i in range(lo, hi)]


def test_streaming_session_matches_oneshot(params):
    """Three waves, the second and third submitted mid-flight."""
    jparams, tparams = params
    n = 18
    cfg = JEngineConfig(**BASE)
    prompts = prompts_for(1, n)
    sess = session(tparams, cfg, capacity=n, max_new_per_burst=4,
                   bursts_per_chunk=2)
    finished = {}
    sess.submit(reqs(prompts, 0, 6))
    sess.step()
    finished.update((r.id, r.tokens) for r in sess.poll())
    sess.submit(reqs(prompts, 6, 12))
    sess.step()
    sess.step()
    finished.update((r.id, r.tokens) for r in sess.poll())
    sess.submit(reqs(prompts, 12, n))
    finished.update((r.id, r.tokens) for r in sess.close())
    assert finished == jax_oneshot(jparams, cfg, prompts)


def test_streaming_pipelined_observe_matches_oneshot(params):
    """dispatch + lag-delayed observe + snapshot polls, with rows recycled
    (capacity < n): a stale snapshot must not surface a recycled row's new
    occupant as finished (the n_submitted_at bound)."""
    jparams, tparams = params
    n = 22
    cfg = JEngineConfig(**BASE)
    prompts = prompts_for(2, n)
    sess = session(tparams, cfg, capacity=12, max_new_per_burst=4,
                   observe_lag=2)
    finished = {}
    submitted = 0
    for _ in range(400):
        take = min(3, n - submitted, sess.free_capacity)
        if take:
            sess.submit(reqs(prompts, submitted, submitted + take))
            submitted += take
        sess.dispatch()
        s = sess.observe()
        if s is not None and s["finished_total"]:
            for r in sess.poll(s["fin_lens"], s["n_submitted_at"]):
                assert r.id not in finished
                finished[r.id] = r.tokens
        if submitted == n and len(finished) == n:
            break
    finished.update((r.id, r.tokens) for r in sess.close())
    assert sess.n_submitted == n > sess.capacity
    assert finished == jax_oneshot(jparams, cfg, prompts)


def test_streaming_fused_step_observe_matches_oneshot(params):
    """step(observe=True) brings the final_lens snapshot with the status;
    polls from it collect each request once, rows recycled."""
    jparams, tparams = params
    n = 20
    cfg = JEngineConfig(**BASE)
    prompts = prompts_for(3, n)
    sess = session(tparams, cfg, capacity=9, max_new_per_burst=4,
                   bursts_per_chunk=2)
    finished = {}
    submitted = 0
    for _ in range(400):
        take = min(3, n - submitted, sess.free_capacity)
        if take:
            sess.submit(reqs(prompts, submitted, submitted + take))
            submitted += take
        s = sess.step(observe=True)
        if s["finished_total"]:
            for r in sess.poll(s["fin_lens"], s["n_submitted_at"]):
                assert r.id not in finished
                finished[r.id] = r.tokens
        if submitted == n and len(finished) == n:
            break
    finished.update((r.id, r.tokens) for r in sess.close())
    assert sess.n_submitted == n > sess.capacity
    assert finished == jax_oneshot(jparams, cfg, prompts)


def test_streaming_session_int8_matches_oneshot(params):
    """Quantized KV: the per-page scale rule is position-based, so slot
    and arrival timing cannot change the stream."""
    jparams, tparams = params
    n = 12
    cfg = JEngineConfig(**BASE, kv_dtype="int8")
    prompts = prompts_for(4, n)
    sess = session(tparams, cfg, capacity=n, max_new_per_burst=4,
                   bursts_per_chunk=2)
    sess.submit(reqs(prompts, 0, 5))
    sess.step()
    sess.submit(reqs(prompts, 5, n))
    finished = {r.id: r.tokens for r in sess.close()}
    assert finished == jax_oneshot(jparams, cfg, prompts)


def test_streaming_session_rejects_overlong_prompt(params):
    """submit() enforces max_prompt_len, not the padded power-of-two
    buffer width: an n_seq-length prompt would scatter its first decode
    token into the next request's output row."""
    jparams, tparams = params
    cfg = JEngineConfig(n_slots=8, page_size=16, n_pages=32)
    sess = session(tparams, cfg, capacity=4, max_prompt_len=40)
    assert sess.s_pre == 64
    with pytest.raises(ValueError, match="max_prompt_len"):
        sess.submit([T.Request(0, list(range(1, 42)))])
    assert sess.n_submitted == 0
    sess.submit([T.Request(0, list(range(1, 41)))])   # exactly the maximum
    got = {r.id: r.tokens for r in sess.close()}
    assert got == jax_oneshot(jparams, cfg, [list(range(1, 41))])


def test_streaming_session_capacity_recycling(params):
    """capacity bounds the requests in flight, not the session's lifetime:
    the rows of collected requests are reused."""
    jparams, tparams = params
    n, cap = 30, 8
    cfg = JEngineConfig(n_slots=4, page_size=16, n_pages=16,
                        n_forward_rounds=4, max_prefill_batch=4)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 255, int(rng.integers(1, 24))).tolist()
               for _ in range(n)]
    sess = session(tparams, cfg, capacity=cap, bursts_per_chunk=2)
    submitted, done, guard = 0, {}, 0
    while len(done) < n:
        k = min(sess.free_capacity, n - submitted)
        if k:
            sess.submit(reqs(prompts, submitted, submitted + k))
            submitted += k
        sess.step()
        done.update((r.id, r.tokens) for r in sess.poll())
        guard += 1
        assert guard < 500, "recycling session made no progress"
    assert sess.n_submitted == n > cap
    assert done == jax_oneshot(jparams, cfg, prompts)


def test_streaming_session_stall_detection_raises(params):
    """The two-chunks-without-progress detector fires when the pool can
    never admit pending work: the free list is emptied by hand with every
    slot dead and unallocated and a request queued."""
    _, tparams = params
    cfg = JEngineConfig(n_slots=4, page_size=16, n_pages=16,
                        n_forward_rounds=2, max_prefill_batch=4)
    sess = session(tparams, cfg, capacity=4, max_prompt_len=16)
    sess.submit([T.Request(0, [1, 2, 3])])
    sess.st.free_top.zero_()
    with pytest.raises(RuntimeError, match="stalled"):
        sess.close()


def test_streaming_session_backpressure_raises(params):
    """submit() past free_capacity raises and takes nothing; what was
    accepted still finishes, equal to the JAX one-shot engine."""
    jparams, tparams = params
    cfg = JEngineConfig(n_slots=4, page_size=16, n_pages=16,
                        n_forward_rounds=4, max_prefill_batch=4)
    prompts = [[1, 2, 3], [4, 5], [6], [7, 8, 9, 10]]
    sess = session(tparams, cfg, capacity=4, max_prompt_len=16)
    sess.submit(reqs(prompts, 0, 4))
    assert sess.free_capacity == 0
    with pytest.raises(ValueError, match="backpressure"):
        sess.submit([T.Request(9, [1])])
    assert sess.n_submitted == 4
    got = {r.id: r.tokens for r in sess.close()}
    assert got == jax_oneshot(jparams, cfg, prompts)
    assert sess.free_capacity == 4


def test_overcommit_streaming_session_token_exact():
    """Overcommit under waves of arrivals on a pool at 75% of the full
    grant (growth, preemption and the device retry stack all active):
    every output equals the uncontended one-shot run of the JAX engine."""
    model = JModelConfig(n_vocab=256, emb_dim=64, n_seq=64, n_heads=1,
                         eof_token_id=255)
    jparams, tparams = params_for(model, 5)
    n = 28
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 255, int(rng.integers(1, 21))).tolist()
               for _ in range(n)]
    oracle_cfg = JEngineConfig(n_slots=8, n_pages=32, page_size=16,
                               n_forward_rounds=4, init_num_pages=2,
                               max_prefill_batch=8)
    cfg = JEngineConfig(n_slots=8, n_pages=24, page_size=16,
                        n_forward_rounds=4, init_num_pages=2,
                        max_prefill_batch=8, overcommit=True)
    sess = session(tparams, cfg, capacity=12, model=model,
                   max_new_per_burst=8, bursts_per_chunk=2)
    done, submitted, guard = {}, 0, 0
    while len(done) < n:
        k = min(sess.free_capacity, n - submitted, 5)
        if k:
            sess.submit(reqs(prompts, submitted, submitted + k))
            submitted += k
        sess.step()
        done.update((r.id, r.tokens) for r in sess.poll())
        guard += 1
        assert guard < 500, "overcommit streaming made no progress"
    sess.close()
    assert sess.n_submitted == n > 12
    assert sess.stats.preemptions > 0
    assert done == jax_oneshot(jparams, oracle_cfg, prompts, model)
