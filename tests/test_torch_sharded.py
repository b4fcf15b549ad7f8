"""The port's dp x tp mesh (parallel/sharded.py, parallel/engine.py) against
the JAX package's single-chip oracles: tests/test_sharded.py case for case.

The mesh runs as gloo ranks on the CPU (parallel/launch.run_ranks, one
process per rank, world sizes 2 and 4). The rank bodies are
parallel/workers.py; every world-4 case runs in ONE mesh, started once for
the module. Where the JAX test needs 8 devices a world-4 stand-in keeps
its point:

  * test_sharded_matches_unsharded: (dp, tp) = (2, 4) runs as (1, 4),
    (4, 2) as (2, 2), (8, 1) as (4, 1); (1, 4) as in JAX. Inputs come
    from the seed of the JAX case id;
  * the engine end-to-end cases (JAX: 8 devices, tp=4) run dp=2 x tp=2;
  * the native-vs-Python sharded engines (JAX: 8 devices, tp=2) run
    dp=2 x tp=2.

Oracle: the JAX test's own, run here on numpy inputs made from a seed, with
JAX ``init_params`` weights carried over by ``params_from_numpy``: the
unsharded JAX paged functions ("jnp"), or the single-chip JAX PagedEngine.
The int8-pallas engine case takes the JAX ``jnp`` engine as its oracle (the
JAX package's tests hold its Pallas kernel token-exact with it). Port
attention names: jnp -> torch, pallas -> paged, grouped -> grouped. Tokens
are exact; pool bytes are compared at rtol = atol = 2e-5 for the written
K/V rows, as in the JAX test.

Also here: a rank's sharded-then-fused weights byte-equal to its slice of
JAX's per-rank interleaved fuse_qkv_params(tp), update_page_scales with a
max over split features equal to JAX's, and TpShardCtx's four seams at
world size 2 against the one-device functions."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from min_llm_inference_tpu.config import EngineConfig, ModelConfig
from min_llm_inference_tpu.models.paged import init_paged_state, make_paged_fns
from min_llm_inference_tpu.models.params import fuse_qkv_params, init_params
from min_llm_inference_tpu.ops import quant as jquant
from min_llm_inference_tpu.ops.quant import quantize_params
import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch.ops import quant as tquant
from min_llm_inference_tpu_torch.parallel import run_ranks, workers

MODEL = ModelConfig(
    n_vocab=128, emb_dim=64, n_seq=32, n_layers=2, n_heads=4,
    ffn_dim=128, use_output_proj=True, use_layernorm=True,
    eof_token_id=127,
)
ENGINE = EngineConfig(
    n_slots=8, n_forward_rounds=3, page_size=8, n_pages=32,
    init_num_pages=2, max_prefill_batch=8,
)
TMODEL = T.ModelConfig(**dataclasses.asdict(MODEL))

# JAX (dp, tp) -> the world-4 stand-in that runs here
STAND_IN = {(2, 4): (1, 4), (4, 2): (2, 2), (8, 1): (4, 1), (1, 4): (1, 4)}
MATRIX = [
    ("float32", "jnp"), ("float32", "pallas"), ("float32", "grouped"),
    ("int8", "jnp"), ("int8", "pallas"), ("int8", "grouped"),
    # packed int4 KV: per-head nibble halves pack rank-locally under tp
    ("int4", "jnp"), ("int4", "grouped"),
]
PORT_ATTN = {"jnp": "torch", "pallas": "paged", "grouped": "grouped"}
E2E = [("float32", "jnp"), ("int8", "pallas")]


def numpy_params(seed):
    return jax.tree_util.tree_map(
        np.asarray, init_params(jax.random.PRNGKey(seed), MODEL))


def build_inputs(rng, dp):
    """tests/test_sharded.py::build_inputs: each dp group's slots use page
    ids local to its pool shard; the oracle gets global ids."""
    B, W = ENGINE.n_slots, ENGINE.pages_per_slot(MODEL.n_seq)
    NP_loc = ENGINE.n_pages // dp
    B_loc = B // dp
    local_table = np.zeros((B, W), np.int32)
    global_table = np.zeros((B, W), np.int32)
    for g in range(dp):
        pages = rng.permutation(NP_loc)[: B_loc * W].reshape(B_loc, W)
        local_table[g * B_loc: (g + 1) * B_loc] = pages
        global_table[g * B_loc: (g + 1) * B_loc] = pages + g * NP_loc
    lengths = rng.integers(0, MODEL.n_seq - ENGINE.n_forward_rounds,
                           B).astype(np.int32)
    lengths[0] = 0
    prompts = rng.integers(0, MODEL.eof_token_id,
                           (B, MODEL.n_seq)).astype(np.int32)
    last = rng.integers(0, MODEL.eof_token_id, B).astype(np.int32)
    return prompts, lengths, last, local_table, global_table


def run_unsharded(params, engine_cfg, prompts, lengths, last, global_table):
    """tests/test_sharded.py::run_unsharded: the JAX paged functions
    ("jnp") on the global layout; returns (state, lengths, last, tokens)."""
    params = fuse_qkv_params(params)
    u_prefill, u_decode = make_paged_fns(MODEL, engine_cfg, "jnp")
    u_state = u_prefill(params, init_paged_state(MODEL, engine_cfg),
                        prompts, lengths, global_table)
    W = global_table.shape[1]
    packed = np.full((engine_cfg.n_slots, 2 + W), -1, dtype=np.int32)
    packed[:, 2:] = global_table
    return u_decode(params, u_state, jnp.asarray(packed),
                    jnp.asarray(lengths), jnp.asarray(last))


def step_case(key, engine_cfg, attention, dp, tp, param_seed, input_seed,
              pools=False):
    """One step_fns case: (key, its inputs, its worker call)."""
    rng = np.random.default_rng(input_seed)
    inputs = build_inputs(rng, dp)
    prompts, lengths, last, local_table, _ = inputs
    call = ("step_fns", dict(
        model=dataclasses.asdict(MODEL),
        engine=dataclasses.asdict(engine_cfg), attention=attention, tp=tp,
        recipe=("numpy", numpy_params(param_seed)), prompts=prompts,
        lengths=lengths, last=last, local_table=local_table, pools=pools))
    return key, inputs, call


def engine_prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, MODEL.eof_token_id,
                         int(rng.integers(1, 20))).tolist()
            for _ in range(24)]


def step_cases():
    out = []
    for (dp0, tp0), (dp, tp) in STAND_IN.items():
        out.append(step_case(("unsharded", dp0, tp0), ENGINE, "torch", dp,
                             tp, 3, dp0 * 10 + tp0))
    for kv, attn in MATRIX:
        out.append(step_case(("matrix", kv, attn),
                             dataclasses.replace(ENGINE, kv_dtype=kv),
                             PORT_ATTN[attn], 2, 2, 3, 17))
    out.append(step_case(("pages",), ENGINE, "torch", 2, 2, 5, 0,
                         pools=True))
    return out


def engine_cases():
    prompts = engine_prompts()
    out = []
    for kv, attn in E2E:
        cfg = dataclasses.replace(ENGINE, kv_dtype=kv)
        out.append((("e2e", kv, attn), cfg, ("engine_run", dict(
            kind="paged", model=dataclasses.asdict(MODEL),
            engine=dataclasses.asdict(cfg), recipe=("numpy", numpy_params(7)),
            prompts=prompts, tp=2, attention=PORT_ATTN[attn]))))
    cfg = dataclasses.replace(ENGINE, kv_dtype="int8")
    for kind in ("paged", "native"):
        out.append((("native", kind), cfg, ("engine_run", dict(
            kind=kind, model=dataclasses.asdict(MODEL),
            engine=dataclasses.asdict(cfg), recipe=("numpy", numpy_params(7)),
            prompts=prompts, tp=2, attention="torch"))))
    return out


@pytest.fixture(scope="module")
def mesh4():
    """Every world-4 case of the module, in one mesh of 4 gloo ranks:
    {key: (inputs or config, [per-rank results])}."""
    from min_llm_inference_tpu_torch.runtime.native import native_available

    native_available()  # build the C++ scheduler once, before the ranks
    cases = step_cases() + engine_cases()
    results = run_ranks(workers.run_cases, 4, ([c[2] for c in cases],),
                        device="cpu", timeout=300)
    return {key: (info, [r[k] for r in results])
            for k, (key, info, _) in enumerate(cases)}


def assemble(ranks, name):
    """The global [B, ...] rows of a step_fns output from each group's
    first rank."""
    by_group = sorted((r["group"], r[name]) for r in ranks
                      if r["tp_rank"] == 0)
    return np.concatenate([rows for _, rows in by_group])


def check_steps(inputs, ranks, engine_cfg, param_seed):
    prompts, lengths, last, _, global_table = inputs
    params = init_params(jax.random.PRNGKey(param_seed), MODEL)
    _, u_len, u_last, u_toks = run_unsharded(
        params, engine_cfg, prompts, lengths, last, global_table)
    for r in ranks:  # the tp ranks of a group agree
        same = [o for o in ranks if o["group"] == r["group"]]
        for o in same:
            np.testing.assert_array_equal(o["tokens"], r["tokens"])
    np.testing.assert_array_equal(np.asarray(u_toks),
                                  assemble(ranks, "tokens"))
    np.testing.assert_array_equal(np.asarray(u_len),
                                  assemble(ranks, "lengths"))
    np.testing.assert_array_equal(np.asarray(u_last),
                                  assemble(ranks, "last"))


@pytest.mark.parametrize("dp,tp", list(STAND_IN))
def test_sharded_matches_unsharded(mesh4, dp, tp):
    inputs, ranks = mesh4[("unsharded", dp, tp)]
    check_steps(inputs, ranks, ENGINE, 3)


@pytest.mark.parametrize("kv_dtype,attention", MATRIX)
def test_sharded_matrix_kv_dtype_x_attention(mesh4, kv_dtype, attention):
    """int8/int4 page scales max-reduced over tp to the full-row absmax,
    and the kernels' plain versions at local widths, reproduce the
    unsharded JAX token stream."""
    inputs, ranks = mesh4[("matrix", kv_dtype, attention)]
    check_steps(inputs, ranks, dataclasses.replace(ENGINE, kv_dtype=kv_dtype),
                3)


def test_sharded_kv_pages_match_unsharded(mesh4):
    """After prefill, the ranks' pool shards put together are the oracle's
    global pool at every written K/V row (features split over tp)."""
    (prompts, lengths, last, _, global_table), ranks = mesh4[("pages",)]
    params = init_params(jax.random.PRNGKey(5), MODEL)
    u_prefill, _ = make_paged_fns(MODEL, ENGINE, "jnp")
    u_state = u_prefill(fuse_qkv_params(params),
                        init_paged_state(MODEL, ENGINE), prompts, lengths,
                        global_table)
    dp = tp = 2
    NP_loc = ENGINE.n_pages // dp
    P = ENGINE.page_size
    for li in range(MODEL.n_layers):
        want = np.asarray(u_state.kv_pages[li])
        got = np.zeros_like(want)
        d = want.shape[-1] // tp
        for r in ranks:
            g, t = r["group"], r["tp_rank"]
            got[g * NP_loc:(g + 1) * NP_loc, ..., t * d:(t + 1) * d] = (
                r["pools"][li])
        for b in range(ENGINE.n_slots):
            for pos in range(int(lengths[b])):
                gp = global_table[b, pos // P]
                np.testing.assert_allclose(
                    got[gp, :, pos % P], want[gp, :, pos % P],
                    rtol=2e-5, atol=2e-5)


def jax_paged_engine_tokens(cfg, prompts, attention="jnp"):
    from min_llm_inference_tpu import ItemStorage, PagedEngine, Request

    store = ItemStorage()
    for i, p in enumerate(prompts):
        store.add_new_item(Request(i, list(p)))
    params = init_params(jax.random.PRNGKey(7), MODEL)
    PagedEngine(params, MODEL, cfg, attention_impl=attention).run(store)
    return {i: r.tokens for i, r in store.finished.items()}


def check_engine(ranks, want):
    for r in ranks:  # every rank's ItemStorage holds every request
        assert len(r["tokens"]) == len(want)
        for i in want:
            assert r["tokens"][i] == want[i], (r["rank"], i)


@pytest.mark.parametrize("kv_dtype,attention", E2E)
def test_sharded_engine_end_to_end_matches_single_chip(mesh4, kv_dtype,
                                                       attention):
    """ShardedPagedEngine over dp=2 x tp=2: every request token-exact with
    the single-chip JAX PagedEngine ("jnp" stands in for "pallas")."""
    cfg, ranks = mesh4[("e2e", kv_dtype, attention)]
    check_engine(ranks, jax_paged_engine_tokens(cfg, engine_prompts()))
    assert all(r["stats"]["bursts"] > 0 for r in ranks)


def test_sharded_native_engine_matches_python_sharded(mesh4):
    """Each group's C++ scheduler (one per rank, local slot and page space)
    gives the tokens of the Python-scheduled sharded engine, and both the
    single-chip JAX engine's."""
    cfg, native = mesh4[("native", "native")]
    _, python = mesh4[("native", "paged")]
    for a, b in zip(native, python):
        assert a["tokens"] == b["tokens"], a["rank"]
    check_engine(native, jax_paged_engine_tokens(cfg, engine_prompts()))


def cpu_mesh(tp, tp_rank):
    """A stand-in Mesh of one dp group, at ``tp_rank`` of ``tp``, on the
    CPU (no process group: shard_params and the state only read it)."""
    from min_llm_inference_tpu_torch.parallel.sharded import Mesh

    return Mesh(world_size=tp, dp=1, tp=tp, rank=tp_rank, group=0,
                tp_rank=tp_rank, device=torch.device("cpu"), backend="gloo",
                tp_group=None, host_group=None)


@pytest.mark.parametrize("tp,tp_rank",
                         [(1, 0), (2, 0), (2, 1)] + [(4, r) for r in range(4)])
def test_rank_fused_params_match_jax_interleave(tp, tp_rank):
    """A rank's shard fused by the local engine, [q_l|k_l|v_l], is byte for
    byte the rank's column slice of JAX's per-rank interleaved wqkv
    (fuse_qkv_params(params, tp): [q_r0|k_r0|v_r0|q_r1|...]), and so for
    wkv; every other leaf is its PARAM_SPECS slice."""
    from min_llm_inference_tpu_torch.parallel.sharded import shard_params

    jparams = init_params(jax.random.PRNGKey(1), MODEL)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    got = T.fuse_qkv_params(shard_params(
        T.params_from_numpy(tree, TMODEL, device="cpu"),
        cpu_mesh(tp, tp_rank)))
    want = fuse_qkv_params(jparams, tp)
    for gl, wl in zip(got["layers"], want["layers"]):
        for name in ("wqkv", "wkv"):
            w = np.asarray(wl[name])
            d = w.shape[1] // tp
            np.testing.assert_array_equal(
                gl[name].numpy(), w[:, tp_rank * d:(tp_rank + 1) * d])
        d = MODEL.emb_dim // tp
        np.testing.assert_array_equal(
            gl["wo"].numpy(),
            np.asarray(wl["wo"])[tp_rank * d:(tp_rank + 1) * d])
    d = MODEL.emb_dim // tp
    np.testing.assert_array_equal(
        got["wte"].numpy(),
        np.asarray(want["wte"])[:, tp_rank * d:(tp_rank + 1) * d])


def test_shard_params_refuses_weight_quantized_leaves():
    """Weight quantization is a single-device feature, as in JAX's
    shard_params."""
    from min_llm_inference_tpu_torch.parallel.sharded import shard_params

    tree = jax.tree_util.tree_map(np.asarray, quantize_params(
        init_params(jax.random.PRNGKey(1), MODEL), "int8"))
    params = T.params_from_numpy(tree, TMODEL, device="cpu")
    with pytest.raises(ValueError, match="single-device"):
        shard_params(params, cpu_mesh(2, 0))


@pytest.mark.parametrize("qmax", [127.0, 7.0])
def test_update_page_scales_reduce_matches_jax(qmax):
    """A max over the tp shards' absmax (each rank holding D/tp features)
    gives the JAX scales of the full rows, bit for bit."""
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((6, 64)).astype(np.float32)
    pid = np.array([2, 9, 0, 9, 5, 7], np.int32)  # 9: out of range
    want = jquant.update_page_scales(jnp.zeros(9), jnp.asarray(rows),
                                     jnp.asarray(pid), None, qmax)
    tp = 4
    shards = np.split(rows, tp, axis=1)
    local = [torch.from_numpy(s.copy()).abs().amax(dim=-1) for s in shards]

    for t in range(tp):
        seen = []

        def reduce(absmax):
            # stands in for the all-reduce: this rank's absmax (the
            # argument), maxed with the other ranks'
            seen.append(absmax)
            return torch.stack(
                [absmax] + [local[o] for o in range(tp) if o != t]).amax(0)

        got = tquant.update_page_scales(
            torch.zeros(9), torch.from_numpy(shards[t].copy()),
            torch.from_numpy(pid), qmax, absmax_reduce=reduce)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert len(seen) == 1 and torch.equal(seen[0], local[t])


def test_tp_shard_ctx_seams_at_world_size_2():
    """embed (zero-padded sum), logits (f32 partial + sum), psum and the
    pmax of the page scales, over 2 gloo ranks, against one device."""
    for diffs in run_ranks(workers.seams, 2, (2,), device="cpu",
                           timeout=120):
        assert diffs["embed"] == 0.0
        assert diffs["pmax_scales"] == 0.0
        assert diffs["logits"] < 1e-5
        assert diffs["psum"] < 1e-5


def test_sharded_state_local_shapes():
    """A rank's pools hold its dp group's pages and its D/tp features
    (D/2/tp packed int4), its AutoState its group's slots and request
    rows: JAX's KV_SPEC / auto_state_specs shards, made locally."""
    from min_llm_inference_tpu_torch.parallel.autonomous import (
        init_sharded_auto_state,
    )
    from min_llm_inference_tpu_torch.parallel.sharded import (
        Mesh,
        init_sharded_state,
        local_engine_cfg,
    )

    mesh = Mesh(world_size=4, dp=2, tp=2, rank=3, group=1, tp_rank=1,
                device=torch.device("cpu"), backend="gloo", tp_group=None,
                host_group=None)
    W = ENGINE.pages_per_slot(MODEL.n_seq)
    for kv, feat in (("float32", 32), ("int8", 32), ("int4", 16)):
        cfg = T.EngineConfig(**dataclasses.asdict(
            dataclasses.replace(ENGINE, kv_dtype=kv)))
        st = init_sharded_state(TMODEL, cfg, mesh)
        assert st.kv_pages[0].shape == (16, 2, 8, feat)
        auto = init_sharded_auto_state(TMODEL, local_engine_cfg(cfg, 2),
                                       mesh, 5)
        assert auto.kv.kv_pages[1].shape == (16, 2, 8, feat)
        assert auto.page_table.shape == (4, W)
        assert auto.out_tokens.shape == (5, MODEL.n_seq)
        assert int(auto.free_top) == 16 // W
        if kv != "float32":
            assert auto.kv.k_scales[0].shape == (16,)


def test_run_ranks_raises_for_a_failed_rank_or_the_deadline():
    """A rank that raises ends the mesh with its log in the error; a mesh
    past its deadline is ended too (no rank left running)."""
    with pytest.raises(RuntimeError, match="must divide the world size"):
        run_ranks(workers.seams, 2, (3,), device="cpu", timeout=120)
    with pytest.raises(TimeoutError):
        run_ranks(workers.seams, 2, (2,), device="cpu", timeout=0.5)
