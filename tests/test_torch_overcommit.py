"""The port's AutonomousEngine under overcommit vs the JAX package's.

Overcommit grants half-groups, grows slots on demand, preempts the
youngest live slots when the pool runs dry and re-admits them from a device
retry stack. The port's scheduler step is held against the JAX one on the
same state (every output equal), and the engine token for token against the
JAX engine (its gather oracle "jnp", whose outputs the JAX tests hold equal
to its kernel paths), with the decode ring off, on with the grouped
kernel's mode (c), and on with the flat kernel. Mirrors test_overcommit.py
(StreamingSession's case is in test_torch_streaming.py) and
test_autonomous.py::test_autonomous_subbursts_overcommit_match."""

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
from min_llm_inference_tpu.runtime import autonomous as jauto
import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch.runtime import autonomous as tauto

# tiny CPU tensors: PyTorch's intra-op threads would only contend with the
# other pytest-xdist workers, one per core
torch.set_num_threads(1)


def model(n_layers=1, emb=64):
    return JModelConfig(
        n_vocab=256, emb_dim=emb, n_seq=64, n_layers=n_layers,
        n_heads=1 if n_layers == 1 else 2,
        ffn_dim=0 if n_layers == 1 else emb * 2,
        use_output_proj=n_layers > 1, use_layernorm=n_layers > 1,
        eof_token_id=255)


def params_for(m, seed):
    jparams = init_params(jax.random.PRNGKey(seed), m)
    tparams = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                  T.ModelConfig(**dataclasses.asdict(m)),
                                  device="cpu")
    return jparams, tparams


def random_prompts(rng, n, max_plen):
    return [rng.integers(0, 255, int(rng.integers(1, max_plen + 1))).tolist()
            for _ in range(n)]


def run_jax(jparams, m, cfg, prompts, **kw):
    js = JItemStorage()
    for i, p in enumerate(prompts):
        js.add_new_item(JRequest(i, list(p)))
    jauto.AutonomousEngine(jparams, m, cfg, attention_impl="jnp", **kw).run(js)
    return [js.finished[i].tokens for i in range(len(prompts))]


def run_port(tparams, m, cfg, prompts, **kw):
    ts = T.ItemStorage()
    for i, p in enumerate(prompts):
        ts.add_new_item(T.Request(i, list(p)))
    eng = T.AutonomousEngine(tparams, T.ModelConfig(**dataclasses.asdict(m)),
                             T.EngineConfig(**dataclasses.asdict(cfg)),
                             attention_impl="grouped", device="cpu", **kw)
    eng.run(ts)
    assert len(ts.finished) == len(prompts)
    return [ts.finished[i].tokens for i in range(len(prompts))], eng


# the three ways the port attends under overcommit: no ring (fused write),
# ring + grouped mode (c), ring + the flat kernel
RINGS = {"no-ring": dict(decode_ring=False),
         "ring-c": dict(decode_ring=True),
         "ring-flat": dict(decode_ring=True, attn_flat=True)}


@pytest.mark.parametrize("ring", list(RINGS))
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_overcommit_pool_pressure_token_exact(kv_dtype, ring):
    """16 slots x 4 pages = 64 pages wanted, the pool holds 24."""
    m = model()
    jparams, tparams = params_for(m, 0)
    prompts = random_prompts(np.random.default_rng(0), 40, 24)
    cfg = JEngineConfig(n_slots=16, n_pages=24, page_size=16,
                        n_forward_rounds=4, kv_dtype=kv_dtype,
                        init_num_pages=2, max_prefill_batch=16,
                        overcommit=True, **RINGS[ring])
    kw = dict(max_new_per_burst=16, bursts_per_chunk=2)
    got, eng = run_port(tparams, m, cfg, prompts, **kw)
    assert got == run_jax(jparams, m, cfg, prompts, **kw)
    assert eng.stats.preemptions > 0


@pytest.mark.parametrize("ring", list(RINGS))
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_overcommit_forced_preemption_token_exact(kv_dtype, ring):
    """4 half-groups for 8 slots whose requests all run to the 64-token
    cap: growth must preempt. The port equals the JAX engine and an
    uncontended full-grant run of its own."""
    m = model()
    jparams, tparams = params_for(m, 1)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 254, 2).tolist() for _ in range(12)]
    tight = JEngineConfig(n_slots=8, n_pages=8, page_size=16,
                          n_forward_rounds=4, kv_dtype=kv_dtype,
                          init_num_pages=2, max_prefill_batch=8,
                          overcommit=True, **RINGS[ring])
    kw = dict(max_new_per_burst=8, bursts_per_chunk=2)
    got, eng = run_port(tparams, m, tight, prompts, **kw)
    assert eng.stats.preemptions > 0
    assert got == run_jax(jparams, m, tight, prompts, **kw)
    roomy = dataclasses.replace(tight, n_pages=64, overcommit=False)
    want, roomy_eng = run_port(tparams, m, roomy, prompts, **kw)
    assert got == want
    assert roomy_eng.stats.preemptions == 0


def test_overcommit_long_prompt_double_grant():
    """Prompts longer than a half-group (2 pages x 16) get both halves at
    admission."""
    m = model()
    jparams, tparams = params_for(m, 2)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 254, 40).tolist() for _ in range(6)]
    cfg = JEngineConfig(n_slots=8, n_pages=16, page_size=16,
                        n_forward_rounds=4, kv_dtype="int8", init_num_pages=2,
                        max_prefill_batch=8, overcommit=True)
    kw = dict(max_new_per_burst=8, bursts_per_chunk=2)
    got, _ = run_port(tparams, m, cfg, prompts, **kw)
    assert got == run_jax(jparams, m, cfg, prompts, **kw)


def test_overcommit_multilayer_int8_growth():
    """2 layers, int8 KV, growth without preemption (the pool holds every
    slot's both halves)."""
    m = model(n_layers=2, emb=64)
    jparams, tparams = params_for(m, 3)
    prompts = random_prompts(np.random.default_rng(3), 24, 20)
    cfg = JEngineConfig(n_slots=8, n_pages=32, page_size=16,
                        n_forward_rounds=4, kv_dtype="int8", init_num_pages=2,
                        max_prefill_batch=8, overcommit=True,
                        decode_ring=True, attn_flat=True)
    kw = dict(max_new_per_burst=8, bursts_per_chunk=2)
    got, eng = run_port(tparams, m, cfg, prompts, **kw)
    assert eng.stats.preemptions == 0
    assert got == run_jax(jparams, m, cfg, prompts, **kw)


@pytest.mark.parametrize("ring", ["no-ring", "ring-flat"])
def test_overcommit_subbursts_match(ring):
    """Sub-bursts compose with overcommit: the growth lookahead shrinks to
    the sub-burst's rounds; admission and preemption run per sub-burst."""
    m = model()
    jparams, tparams = params_for(m, 4)
    prompts = random_prompts(np.random.default_rng(4), 12, 24)
    outs = []
    for sub in (1, 2):
        cfg = JEngineConfig(n_slots=8, page_size=16, n_pages=16,
                            n_forward_rounds=4, subbursts=sub,
                            overcommit=True, **RINGS[ring])
        got, _ = run_port(tparams, m, cfg, prompts)
        assert got == run_jax(jparams, m, cfg, prompts)
        outs.append(got)
    assert outs[0] == outs[1]


def test_overcommit_host_syncs():
    """Overcommit adds no host sync: nothing is read inside a burst; two
    input uploads, one status read per chunk and one output read, which
    carries the preemption count and the device's counts of skipped
    bursts, rounds and prefill blocks."""
    m = model()
    _, tparams = params_for(m, 1)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 254, 2).tolist() for _ in range(12)]
    cfg = JEngineConfig(n_slots=8, n_pages=8, page_size=16,
                        n_forward_rounds=4, subbursts=2, overcommit=True,
                        decode_ring=True, attn_flat=True)
    _, eng = run_port(tparams, m, cfg, prompts, bursts_per_chunk=2)
    st = eng.stats
    executed = st.bursts - st.skipped
    assert st.preemptions > 0
    assert st.host_syncs == 2 + -(-st.bursts // eng.chunk) + 1
    assert st.rounds == executed * cfg.n_forward_rounds
    assert 0 < st.prefills <= executed * cfg.subbursts


def admission_state(rng, B=8, W=4, P=16, NP=16, R_total=24, S_pre=32):
    """A mid-run overcommit state: live slots, some grown, some about to
    cross into their second half, dead-but-allocated slots, a retry stack
    and a nearly dry pool, as numpy arrays."""
    Hp = W // 2
    NH = NP // Hp
    units = rng.permutation(NH)
    grown = rng.random(B) < 0.4
    table = np.zeros((B, W), np.int32)
    u = 0
    allocated = rng.random(B) < 0.8
    for b in range(B):
        if not allocated[b] or u >= NH:
            allocated[b] = grown[b] = False
            continue
        first = units[u] * Hp + np.arange(Hp)
        u += 1
        if grown[b] and u < NH:
            second = units[u] * Hp + np.arange(Hp)
            u += 1
        else:
            grown[b] = False
            second = first
        table[b] = np.concatenate([first, second])
    lengths = np.where(allocated, rng.integers(1, 2 * Hp * P - 4, B), 0)
    lengths = np.where(grown, lengths, np.minimum(lengths, Hp * P - 1))
    lengths[(rng.random(B) < 0.2) & allocated] = 0       # dead, allocated
    lengths[0] = Hp * P - 1 if allocated[0] and not grown[0] else lengths[0]
    stack = np.zeros(NH, np.int32)
    stack[:NH - u] = units[u:]
    return dict(
        page_table=table, lengths=lengths.astype(np.int32),
        last_tokens=rng.integers(0, 255, B).astype(np.int32),
        rid=rng.permutation(R_total)[:B].astype(np.int32),
        allocated=allocated, queue_head=np.int32(10),
        free_top=np.int32(NH - u), page_stack=stack,
        grown=grown, adm_seq=rng.permutation(B).astype(np.int32),
        seq_ctr=np.int32(B), retry_stack=np.concatenate(
            [[3, 7], np.zeros(R_total - 2)]).astype(np.int32),
        retry_top=np.int32(2),
        out_tokens=np.zeros((R_total, 64), np.int32),
        final_lens=np.zeros(R_total, np.int32),
        prompts=rng.integers(0, 255, (R_total, S_pre)).astype(np.int32),
        plens=rng.integers(1, S_pre + 1, R_total).astype(np.int32))


@pytest.mark.parametrize("seed", range(6))
def test_overcommit_admission_matches_jax(seed):
    """One scheduler step (free, grow, preempt, admit) on the same state:
    every output equal to the JAX step's."""
    s = admission_state(np.random.default_rng(100 + seed))
    cfg = JEngineConfig(n_slots=8, page_size=16, n_pages=16,
                        n_forward_rounds=8, overcommit=True)
    fields = ("page_table", "lengths", "last_tokens", "rid", "allocated",
              "queue_head", "free_top", "page_stack", "out_tokens",
              "final_lens")
    oc_fields = ("grown", "adm_seq", "seq_ctr", "retry_stack", "retry_top")
    jst = jauto.AutoState(kv=None, **{k: jnp.asarray(s[k]) for k in fields},
                          **{k: jnp.asarray(s[k]) for k in oc_fields})
    want = jauto._overcommit_admission(
        cfg, 4, 8, jst, jnp.asarray(s["prompts"]), jnp.asarray(s["plens"]),
        jnp.int32(20))
    tst = tauto.AutoState(
        kv=None, **{k: torch.from_numpy(np.array(s[k])) for k in fields},
        **{k: torch.from_numpy(np.array(s[k])) for k in oc_fields},
        preempted=torch.zeros((), dtype=torch.int32))
    got = tauto._overcommit_admission(
        T.EngineConfig(**dataclasses.asdict(cfg)), 4, 8, tst,
        torch.from_numpy(s["prompts"]), torch.from_numpy(s["plens"]), 20)
    names = ("page_table", "lengths", "last_tokens", "rid", "allocated",
             "queue_head", "free_top", "page_stack", "granted", "plens",
             "prompts", "m", "slot_ids")
    for name, w in zip(names, want[:13]):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(w), err_msg=name)
    for k in oc_fields:
        np.testing.assert_array_equal(got.oc[k].numpy(),
                                      np.asarray(want[13][k]), err_msg=k)
    # the count: rids pushed on the retry stack, less those re-admitted
    p, m, top0 = int(got.oc["preempted"]), int(got.m), int(s["retry_top"])
    assert int(got.oc["retry_top"]) == top0 + p - min(m, top0 + p)
