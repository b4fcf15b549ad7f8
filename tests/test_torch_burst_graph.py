"""The burst's device-side control flow, on the CPU.

The prefill bucket is picked on the device as the JAX burst's
``lax.switch`` index (``sum(m > t)``); a burst whose liveness gate is false
(JAX: ``lax.cond`` into ``skip_burst``) leaves every state tensor as it
was; ``device_if`` / ``device_switch`` call their branch or not on the CPU;
and a second run of one engine reuses its program (buffers, and on CUDA
its graphs). The card's side (graph against eager, byte for byte) is in
tests/test_torch_cuda_kernels.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch.runtime import autonomous as tauto
from min_llm_inference_tpu_torch.runtime.graph import (
    device_if,
    device_switch,
    warming,
)

torch.set_num_threads(1)

MODEL = T.ModelConfig(n_vocab=256, emb_dim=32, n_seq=64, eof_token_id=255)


def numpy_params(model, seed):
    """Uniform(-1, 1) * 0.02 weights with an EOF bias, from numpy."""
    rng = np.random.default_rng(seed)
    D, V = model.emb_dim, model.n_vocab
    wte = (rng.uniform(-1, 1, (V, D)) * 0.02).astype(np.float32)
    wte[model.eof_token_id] += 0.05
    layer = {k: (rng.uniform(-1, 1, (D, D)) * 0.02).astype(np.float32)
             for k in ("wq", "wk", "wv")}
    tree = {"wte": wte, "layers": [layer],
            "wpe": (rng.uniform(-1, 1, (model.n_seq, D)) * 0.02
                    ).astype(np.float32)}
    return T.params_from_numpy(tree, model, device="cpu")


@pytest.fixture(scope="module")
def params():
    return numpy_params(MODEL, 0)


def prompts_for(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, int(rng.integers(1, 24))).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("max_new", [512, 300, 256, 128, 64, 8])
def test_device_bucket_matches_jax(max_new):
    """Every admitted count m in [0, max_new]: the port's device bucket is
    the JAX burst's switch index, and its block holds the m rows."""
    sizes = tauto._prefill_sizes(max_new)
    jsizes = [s for s in (64, 128, 256) if s < max_new] + [max_new]
    assert sizes == jsizes
    m = np.arange(max_new + 1, dtype=np.int32)
    want = np.asarray(sum((jnp.asarray(m) > t).astype(jnp.int32)
                          for t in [0] + jsizes[:-1]))
    got = tauto._prefill_bucket(torch.from_numpy(m), sizes).numpy()
    np.testing.assert_array_equal(got, want)
    blocks = np.asarray([0] + sizes)[got]
    assert (blocks >= m).all() and (blocks[m > 0] < 2 * np.maximum(
        m[m > 0], 64)).all()


def run_to_idle(engine, prompts):
    """A program of ``engine`` driven burst by burst until nothing is live
    or queued: the state a chunk's surplus bursts meet."""
    S = MODEL.n_seq
    n = len(prompts)
    s_pre = min(S, 1 << (max(map(len, prompts)) - 1).bit_length())
    prog = engine._program(n, s_pre, engine._widths())
    prog.reset()
    for i, p in enumerate(prompts):
        prog.prompts[i, :len(p)] = torch.tensor(p)
        prog.plens[i] = len(p)
    prog.n_real.fill_(n)
    B = engine.engine_cfg.n_slots
    for _ in range(200):
        prog.burst(B)
        live, head, _, retry, fin = prog.status.tolist()
        if live == 0 and head == n and retry == 0:
            assert fin == n
            return prog
    raise AssertionError("the queue never drained")


@pytest.mark.parametrize("cfg", [
    dict(kv_dtype="int4", decode_ring=False, subbursts=2),
    dict(kv_dtype="int8", decode_ring=True, attn_dgrid=True,
         sort_admits=True),
    dict(kv_dtype="float32", decode_ring=True, attn_flat=True, subbursts=2),
    dict(kv_dtype="int8", decode_ring=False, overcommit=True, n_pages=16),
], ids=["full-int4", "ring-dgrid-int8", "ring-flat-f32", "overcommit-int8"])
def test_idle_burst_changes_nothing(params, cfg):
    """No live slot and nothing queued: the gate is false and the burst
    leaves every state tensor bit-identical; only the skip counter and the
    status move."""
    ecfg = T.EngineConfig(**{**dict(n_slots=8, page_size=16, n_pages=32,
                                    n_forward_rounds=4), **cfg})
    eng = T.AutonomousEngine(params, MODEL, ecfg, device="cpu",
                             max_new_per_burst=8)
    prog = run_to_idle(eng, prompts_for(3, 12))
    st = prog.st[ecfg.n_slots]
    before = [t.clone() for t in tauto._state_tensors(st)]
    skipped = int(prog.counts[tauto._SKIPPED])
    rounds = int(prog.counts[tauto._ROUNDS])
    assert prog.burst(ecfg.n_slots) == 0
    after = tauto._state_tensors(st)
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert torch.equal(a, b)
    assert int(prog.counts[tauto._SKIPPED]) == skipped + 1
    assert int(prog.counts[tauto._ROUNDS]) == rounds
    assert prog.status.tolist() == tauto._status_of(st).tolist()


def test_device_if_and_switch_on_cpu():
    """On the CPU the predicate is read (no sync: they return 0) and the
    branch runs or not; warming() runs every branch."""
    calls = []
    assert device_if(torch.tensor(True), lambda: calls.append("t")) == 0
    assert device_if(torch.tensor(False), lambda: calls.append("f")) == 0
    assert calls == ["t"]
    branches = [None] + [lambda k=k: calls.append(k) for k in (1, 2, 3)]
    for k in (0, 2, 3, 1):
        assert device_switch(torch.tensor(k, dtype=torch.int32),
                             branches) == 0
    assert calls == ["t", 2, 3, 1]
    with warming():
        device_if(torch.tensor(False), lambda: calls.append("w"))
        device_switch(torch.tensor(0), branches)
    assert calls == ["t", 2, 3, 1, "w", 1, 2, 3]


def test_second_run_reuses_the_program(params):
    """A run resets the program's buffers in place: a second run of the
    same queue shape reuses them (on CUDA, its graphs) and gives the same
    tokens; another shape gets a program of its own."""
    cfg = T.EngineConfig(n_slots=8, page_size=16, n_pages=32,
                         n_forward_rounds=4, kv_dtype="int8",
                         decode_ring=True, subbursts=2)
    eng = T.AutonomousEngine(params, MODEL, cfg, device="cpu",
                             request_capacity=16)
    prompts = prompts_for(4, 12)
    outs = []
    for _ in range(2):
        store = T.ItemStorage()
        for i, p in enumerate(prompts):
            store.add_new_item(T.Request(i, list(p)))
        eng.run(store)
        outs.append([store.finished[i].tokens for i in range(len(prompts))])
        if len(outs) == 1:
            prog, first = eng._run_program, dataclasses.replace(eng.stats)
    assert outs[0] == outs[1]
    assert eng._run_program is prog
    assert eng.stats.bursts == 2 * first.bursts
    assert eng.stats.rounds == 2 * first.rounds
    assert eng.stats.host_syncs == 2 * first.host_syncs
    assert eng.stats.captures == 0           # the CPU captures nothing
    store = T.ItemStorage()
    store.add_new_item(T.Request(0, list(range(1, 40))))
    eng.run(store)
    assert eng._run_program is not prog
