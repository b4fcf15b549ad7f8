"""The port's native C++ scheduler (runtime/native.py over the port's own
copy of csrc/scheduler.cpp, built here by the host C++ compiler):
differential against the port's Python scheduler, and NativePagedEngine
token-exact against the port's PagedEngine and the JAX package's
NativePagedEngine. Mirrors tests/test_native_scheduler.py."""

import dataclasses
import os

import numpy as np
import pytest

import jax

from min_llm_inference_tpu import EngineConfig as JEngineConfig
from min_llm_inference_tpu import ItemStorage as JItemStorage
from min_llm_inference_tpu import ModelConfig as JModelConfig
from min_llm_inference_tpu import Request as JRequest
from min_llm_inference_tpu import init_params
from min_llm_inference_tpu.runtime.engine import (
    NativePagedEngine as JNativePagedEngine,
)
import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch.constants import EMPTY_ROW_TOKEN_ID
from min_llm_inference_tpu_torch.ops import _build
from min_llm_inference_tpu_torch.runtime import native
from min_llm_inference_tpu_torch.runtime.item_storage import (
    ItemStorage,
    ProcessingStorage,
    Request,
    is_done,
)
from min_llm_inference_tpu_torch.runtime.native import NativeScheduler
from min_llm_inference_tpu_torch.runtime.paged_scheduler import (
    PagePool,
    PageTable,
    allocate_or_free_pages,
    insert_new_items_paged,
)


def test_library_is_built_from_the_ports_copy():
    assert native.native_available()
    lib = _build.library_path("scheduler.cpp")
    assert os.path.exists(lib)
    assert os.path.dirname(lib) == _build.BUILD_DIR
    assert os.path.dirname(_build.BUILD_DIR) == os.path.dirname(
        os.path.dirname(native.__file__))


@pytest.mark.parametrize("n_pages,lookahead", [(40, 8), (14, 8), (11, 4)])
def test_native_vs_python_differential(rng, n_pages, lookahead):
    B, S, P, INIT, R = 12, 64, 8, 2, 4
    W = -(-S // P)
    eof = 1023
    n_requests = 40
    plens = [int(rng.integers(1, 40)) for _ in range(n_requests)]

    store = ItemStorage()
    processing = ProcessingStorage()
    pool = PagePool(n_pages)
    table_py = PageTable(B, W)
    prompts_py = np.zeros((B, S), np.int32)
    lengths_py = np.zeros(B, np.int32)
    last_py = np.zeros(B, np.int32)

    sched = NativeScheduler(B, S, n_pages, W, P, INIT, R, eof,
                            lookahead=lookahead)
    table_nt = np.zeros((B, W), np.int32)
    prompts_nt = np.zeros((B, S), np.int32)
    lengths_nt = np.zeros(B, np.int32)
    last_nt = np.zeros(B, np.int32)

    for i in range(n_requests):
        toks = rng.integers(0, eof, plens[i]).tolist()
        store.add_new_item(Request(i, list(toks)))
        sched.add_request(i, toks)

    def py_insert():
        return insert_new_items_paged(
            prompts_py, lengths_py, last_py, store, processing, pool,
            table_py, R, P, INIT, lookahead,
        )

    new_py = py_insert()
    new_nt = sched.insert_new(prompts_nt, lengths_nt, last_nt, table_nt)
    assert new_py == new_nt
    np.testing.assert_array_equal(lengths_py, lengths_nt)
    skip_py = set(new_py)
    n_preempted = 0

    # simulate bursts: each live slot emits R random tokens (EOF-biased),
    # newly admitted slots emit EMPTY (pipelined: one-burst lag)
    for step in range(200):
        results = np.full((B, R), EMPTY_ROW_TOKEN_ID, np.int32)
        for slot in range(B):
            if processing.contains(slot) and slot not in skip_py:
                ln = lengths_py[slot]
                for j in range(R):
                    if ln == 0:
                        break
                    tok = int(rng.integers(0, eof + 1))
                    if rng.random() < 0.15:
                        tok = eof
                    results[slot, j] = tok
                    ln = 0 if (tok == eof or ln + 1 >= S) else ln + 1

        # the Python walk with the pipelined engine's rules
        fin_py = []
        for slot in range(B):
            if slot in skip_py or not processing.contains(slot):
                continue
            req = processing.get(slot)
            finished = empty = False
            for j in range(R):
                tok = int(results[slot, j])
                if tok == EMPTY_ROW_TOKEN_ID:
                    empty = True
                else:
                    req.tokens.append(tok)
                    if len(req.tokens) >= S or tok == eof:
                        finished = True
                if finished or empty:
                    break
            if finished or empty:
                fin_py.append(slot)
            if finished:
                processing.move_to_finished(slot, store)
        for slot in list(processing.slots()):
            req = processing.get(slot)
            lengths_py[slot] = len(req.tokens)
            last_py[slot] = req.tokens[-1]
        for slot in fin_py:
            if not processing.contains(slot):
                lengths_py[slot] = 0

        fin_nt = sched.process_results(results, lengths_nt, last_nt)
        assert fin_py == fin_nt.tolist(), f"step {step}"
        np.testing.assert_array_equal(lengths_py, lengths_nt)

        pre_py = allocate_or_free_pages(
            table_py, pool, processing, store, fin_py, R, P, lookahead
        )
        for s_ in pre_py:
            lengths_py[s_] = 0
        pre_nt = sched.alloc_or_free(np.asarray(fin_py, np.int32), table_nt,
                                     lengths_nt)
        assert pre_py == pre_nt, f"step {step}"
        n_preempted += len(pre_py)
        assert pool.free_count() == sched.free_page_count(), f"step {step}"

        new_py = py_insert()
        new_nt = sched.insert_new(prompts_nt, lengths_nt, last_nt, table_nt)
        assert new_py == new_nt, f"step {step}"
        np.testing.assert_array_equal(lengths_py, lengths_nt)
        np.testing.assert_array_equal(table_py.table, table_nt)
        skip_py = set(new_py)

        assert is_done(store, processing) == sched.is_done()
        if sched.is_done():
            break
    assert sched.is_done(), "differential sim did not drain"
    assert len(store.finished) == sched.finished_count() == n_requests
    for rid, tokens, prompt_len in sched.finished_requests():
        assert tokens == store.finished[rid].tokens
        assert prompt_len == store.finished[rid].prompt_len
    if n_pages < 20:
        assert n_preempted > 0


MODEL = JModelConfig(n_vocab=256, emb_dim=32, n_seq=64, eof_token_id=255)
TMODEL = T.ModelConfig(**dataclasses.asdict(MODEL))
ENGINE = JEngineConfig(n_slots=8, page_size=16, n_pages=8 * 4,
                       max_prefill_batch=4)


@pytest.fixture(scope="module")
def params():
    jparams = init_params(jax.random.PRNGKey(0), MODEL, eof_bias=0.05)
    return jparams, T.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), TMODEL, device="cpu")


def run(engine_cls, params, cfg, prompts, **kw):
    store = T.ItemStorage()
    for i, p in enumerate(prompts):
        store.add_new_item(T.Request(i, list(p)))
    eng = engine_cls(params, TMODEL, T.EngineConfig(**dataclasses.asdict(cfg)),
                     device="cpu", **kw)
    eng.run(store)
    assert len(store.finished) == len(prompts)
    return [store.finished[i].tokens for i in range(len(prompts))], eng


@pytest.mark.parametrize("kv,impl,rounds,n_pages", [
    ("float32", "torch", 1, 32),
    ("int8", "paged", 4, 32),
    ("float32", "grouped", 4, 32),
    ("int8", "paged", 4, 6),        # page pressure: preemption
])
def test_native_engine_matches_python_engine(params, rng, kv, impl, rounds,
                                             n_pages):
    cfg = dataclasses.replace(ENGINE, kv_dtype=kv, n_forward_rounds=rounds,
                              n_pages=n_pages, init_num_pages=2)
    prompts = [rng.integers(0, 255, int(rng.integers(1, 20))).tolist()
               for _ in range(20)]
    counter = T.get_global_throughput_counter()
    counter.reset()
    want, eng_py = run(T.PagedEngine, params[1], cfg, prompts,
                       attention_impl=impl)
    counter.reset()
    got, eng_nt = run(T.NativePagedEngine, params[1], cfg, prompts,
                      attention_impl=impl)
    assert got == want
    assert counter.total_tokens == sum(
        len(g) - len(p) for g, p in zip(got, prompts))
    assert eng_nt.stats == eng_py.stats
    if n_pages < 8:
        assert eng_nt.stats.preemptions > 0


def test_native_engine_matches_jax_native_engine(params, rng):
    prompts = [rng.integers(0, 255, int(rng.integers(1, 20))).tolist()
               for _ in range(20)]
    store = JItemStorage()
    for i, p in enumerate(prompts):
        store.add_new_item(JRequest(i, list(p)))
    JNativePagedEngine(params[0], MODEL, ENGINE).run(store)
    want = [store.finished[i].tokens for i in range(len(prompts))]
    got, _ = run(T.NativePagedEngine, params[1], ENGINE, prompts,
                 attention_impl="torch")
    assert got == want


def test_native_engine_raises_without_a_compiler(params, monkeypatch,
                                                 tmp_path):
    """No C++ compiler: building raises, and NativePagedEngine raises
    rather than becoming PagedEngine."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        _build.build(("scheduler.cpp",))

    # the library loaded by earlier tests is forgotten, so the engine goes
    # through the real build into the empty BUILD_DIR (a failed load is not
    # cached: later tests load the real library again)
    native._load_lib.cache_clear()
    assert not native.native_available()
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        T.NativePagedEngine(params[1], TMODEL,
                            T.EngineConfig(**dataclasses.asdict(ENGINE)),
                            device="cpu")
    assert not os.listdir(tmp_path)
