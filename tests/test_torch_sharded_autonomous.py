"""The port's ShardedAutonomousEngine and ShardedStreamingSession
(parallel/autonomous.py) against the JAX single-chip AutonomousEngine:
tests/test_sharded_autonomous.py case for case, plus the dryrun.

The mesh runs as gloo ranks on the CPU (parallel/launch.run_ranks; rank
bodies in parallel/workers.py). Every world-4 case runs in ONE mesh started
once for the module; the (2, 1) case runs at world size 2 as in JAX. Where
the JAX test needs 8 devices a world-4 stand-in keeps its point:
(n_devices, tp) = (8, 1) runs as dp=4 x tp=1, (8, 2) as dp=2 x tp=2, and
(4, 4) as dp=1 x tp=4 (as in JAX); each case's config is sized by the
stand-in's dp, as the JAX test sizes it by its own.

Oracle: the JAX test's own single-chip engine on the same prompts (made
from a seed), with JAX ``init_params`` weights carried over by
``params_from_numpy``. Where that oracle runs the grouped Pallas kernel in
interpret mode (kv_dtypes int8/int4-grouped, both overcommit oracles) the
JAX single-chip ``jnp`` engine on the same inputs stands in for it (the
JAX package's tests hold the two token-exact). Port attention names: jnp
-> torch, grouped -> grouped. Tokens are exact."""

import dataclasses

import numpy as np
import pytest

import jax

from min_llm_inference_tpu import (
    EngineConfig,
    ItemStorage,
    ModelConfig,
    Request,
    init_params,
)
from min_llm_inference_tpu.runtime.autonomous import AutonomousEngine
import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch.dryrun import dryrun
from min_llm_inference_tpu_torch.parallel import (
    ShardedAutonomousEngine,
    run_ranks,
    workers,
)

MODEL = ModelConfig(
    n_vocab=128, emb_dim=64, n_seq=32, n_layers=2, n_heads=4,
    ffn_dim=128, use_output_proj=True, use_layernorm=True,
    eof_token_id=127,
)
TMODEL = T.ModelConfig(**dataclasses.asdict(MODEL))
PORT_ATTN = {"jnp": "torch", "grouped": "grouped"}

# JAX (n_devices, tp) -> (world size, tp) that runs here
MESHES = {(8, 1): (4, 1), (8, 2): (4, 2), (4, 4): (4, 4), (2, 1): (2, 1)}
KV_DTYPES = [("int8", "grouped"), ("int8", "jnp"), ("int4", "grouped"),
             ("bfloat16", "jnp")]


@pytest.fixture(scope="module")
def jparams():
    return init_params(jax.random.PRNGKey(0), MODEL, eof_bias=0.05)


def recipe():
    return ("numpy", jax.tree_util.tree_map(
        np.asarray, init_params(jax.random.PRNGKey(0), MODEL,
                                eof_bias=0.05)))


def make_prompts(n):
    """tests/test_sharded_autonomous.py::make_store's prompts (the rng
    fixture: default_rng(0))."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        ln = int(rng.integers(1, MODEL.n_seq // 2))
        out.append(rng.integers(0, MODEL.eof_token_id, ln).tolist())
    return out


def single_chip(jparams, cfg, prompts, attention="jnp"):
    store = ItemStorage()
    for i, p in enumerate(prompts):
        store.add_new_item(Request(i, list(p)))
    AutonomousEngine(jparams, MODEL, cfg, attention_impl=attention).run(store)
    return {i: r.tokens for i, r in store.finished.items()}


def match_cfg(dp):
    return EngineConfig(n_slots=2 * dp, page_size=8, n_pages=2 * dp * 4,
                        n_forward_rounds=2, max_prefill_batch=8)


def kv_cfg(kv_dtype):
    dp = 2
    return EngineConfig(n_slots=4 * dp, page_size=8, n_pages=4 * dp * 4,
                        n_forward_rounds=2, kv_dtype=kv_dtype,
                        max_prefill_batch=8)


def overcommit_cfgs(kv_dtype):
    slots, W = 4 * 2, 4
    oc = EngineConfig(n_slots=slots, page_size=8, n_pages=slots * W // 2,
                      n_forward_rounds=2, kv_dtype=kv_dtype,
                      max_prefill_batch=8, overcommit=True)
    full = dataclasses.replace(oc, n_pages=slots * W, overcommit=False)
    return oc, full


SORT_CFG = EngineConfig(n_slots=4, page_size=8, n_pages=16,
                        n_forward_rounds=4, max_prefill_batch=8,
                        kv_dtype="int8", subbursts=2, sort_admits=True)
STREAM_CFG = match_cfg(4)
STREAM_KW = dict(attention_impl="torch", max_new_per_burst=2,
                 bursts_per_chunk=2)


def auto_call(cfg, prompts, tp, attention, **kw):
    return ("engine_run", dict(
        kind="auto", model=dataclasses.asdict(MODEL),
        engine=dataclasses.asdict(cfg), recipe=recipe(), prompts=prompts,
        tp=tp, attention=attention, engine_kw=kw))


def stream_call(n, pipelined):
    return ("stream_run", dict(
        model=dataclasses.asdict(MODEL),
        engine=dataclasses.asdict(STREAM_CFG), recipe=recipe(),
        prompts=make_prompts(n), tp=1, capacity=16, max_prompt_len=16,
        pipelined=pipelined, engine_kw=STREAM_KW))


def mesh_cases(world):
    cases = {}
    for jmesh, (w, tp) in MESHES.items():
        if w == world:
            cases[("match",) + jmesh] = auto_call(
                match_cfg(w // tp), make_prompts(22), tp, "torch",
                max_new_per_burst=2, bursts_per_chunk=2)
    if world == 4:
        for kv, attn in KV_DTYPES:
            cases[("kv", kv, attn)] = auto_call(
                kv_cfg(kv), make_prompts(10), 2, PORT_ATTN[attn])
        for kv in ("float32", "int8"):
            cases[("oc", kv)] = auto_call(overcommit_cfgs(kv)[0],
                                          make_prompts(14), 2, "grouped")
        cases[("stream",)] = stream_call(26, pipelined=True)
        cases[("step_observe",)] = stream_call(18, pipelined=False)
        cases[("sort",)] = auto_call(SORT_CFG, make_prompts(20), 2,
                                     "grouped", max_new_per_burst=2,
                                     bursts_per_chunk=2)
    return cases


def run_mesh(world):
    cases = mesh_cases(world)
    results = run_ranks(workers.run_cases, world, (list(cases.values()),),
                        device="cpu", timeout=300)
    return {key: [r[k] for r in results] for k, key in enumerate(cases)}


@pytest.fixture(scope="module")
def mesh4():
    return run_mesh(4)


@pytest.fixture(scope="module")
def mesh2():
    return run_mesh(2)


def check(ranks, want):
    """Every rank holds every request, token-exact with the oracle."""
    for r in ranks:
        assert len(r["tokens"]) == len(want), r["rank"]
        for i in want:
            assert r["tokens"][i] == want[i], (r["rank"], i)


@pytest.mark.parametrize("n_devices,tp", list(MESHES))
def test_sharded_autonomous_matches_single_chip(jparams, mesh4, mesh2,
                                                n_devices, tp):
    """22 requests (not a multiple of dp: uneven groups) over the mesh."""
    world, tp_here = MESHES[(n_devices, tp)]
    ranks = (mesh4 if world == 4 else mesh2)[("match", n_devices, tp)]
    want = single_chip(jparams, match_cfg(world // tp_here), make_prompts(22))
    check(ranks, want)
    # every rank ran the same bursts and read one status per chunk
    assert len({r["stats"]["bursts"] for r in ranks}) == 1


@pytest.mark.parametrize("kv_dtype,attention", KV_DTYPES)
def test_sharded_autonomous_kv_dtypes(jparams, mesh4, kv_dtype, attention):
    """Quantized KV on the mesh: per-page scales are the full row's absmax
    (a max over tp), so int8/int4 streams stay token-exact."""
    want = single_chip(jparams, kv_cfg(kv_dtype), make_prompts(10))
    check(mesh4[("kv", kv_dtype, attention)], want)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_sharded_autonomous_overcommit_matches_single_chip(jparams, mesh4,
                                                           kv_dtype):
    """Each group's pool holds half the full demand: half-grants, growth
    and preemption inside every group, tokens exact with the single-chip
    overcommit engine and the full-grant one."""
    oc, full = overcommit_cfgs(kv_dtype)
    prompts = make_prompts(14)
    ranks = mesh4[("oc", kv_dtype)]
    check(ranks, single_chip(jparams, full, prompts))
    check(ranks, single_chip(jparams, oc, prompts))


def test_sharded_streaming_matches_oneshot(jparams, mesh4):
    """ShardedStreamingSession (round-robin per-group rings of 4 rows,
    pipelined dispatch/observe, row recycling) equals the one-shot
    single-chip engine."""
    check(mesh4[("stream",)], single_chip(jparams, STREAM_CFG,
                                          make_prompts(26)))


def test_sharded_autonomous_rejects_bad_shapes():
    """n_slots=6 does not divide over dp=4: refused before any process
    group is needed."""
    cfg = T.EngineConfig(n_slots=6, page_size=8, n_pages=24)
    params = T.init_params(0, TMODEL, device="cpu")
    with pytest.raises(ValueError):
        ShardedAutonomousEngine(params, TMODEL, cfg, n_devices=4, tp=1)


def test_sharded_fused_step_observe_matches_oneshot(jparams, mesh4):
    """step(observe=True): one status + final-lengths read per chunk drives
    poll() once per completion, token-exact with the one-shot engine."""
    check(mesh4[("step_observe",)], single_chip(jparams, STREAM_CFG,
                                                make_prompts(18)))


def test_sharded_sort_admits_subbursts_burst_flush(jparams, mesh4):
    """Sorted admission waves + two sub-bursts with the burst-wide ring
    (one flush, per-slot ring_r0) under dp=2 x tp=2 with int8 KV."""
    check(mesh4[("sort",)], single_chip(jparams, SORT_CFG, make_prompts(20)))


def test_dryrun_four_ranks_on_cpu():
    """python -m min_llm_inference_tpu_torch.dryrun 4 --device cpu: both
    mesh engines agree on 24 requests at dp=1 x tp=4."""
    line, _ = dryrun(4, device="cpu", timeout=300)
    assert line.startswith("dryrun OK: 4 ranks, dp=1 tp=4")
