"""The program's tracing (utils/profiling), on the CPU unless marked.

- ``phase`` under a graph capture records no host time; with tracing off it
  launches no stamp, with tracing on two per region; a device phase table
  folds into ``PhaseStats`` as device seconds and calls.
- AutonomousEngine's slot-round counter: executed slot-rounds are the sum
  of width x rounds of the executed bursts, below rounds x n_slots once the
  drain narrows, and above the tokens served.
- StreamingSession's admission waits: the ThroughputCounter gets one per
  collected request, from its ``submit`` to the read that shows it
  admitted, tracing on or off.
- ``AutonomousEngine.run`` notes a request's first token at the status read
  that shows it admitted, so first-token times fall inside the batch.
- On the card: a burst graph captured with tracing off holds no stamp
  kernel, one captured with tracing on two per region its capture entered,
  and the folded device seconds nest (each region's inside ``burst``).

No JAX here: the card-marked test runs with ``--noconftest``.
"""

import contextlib
import json
import os
import re
import time

import numpy as np
import pytest
import torch

import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch import bench as tbench
from min_llm_inference_tpu_torch.metrics import get_global_throughput_counter
from min_llm_inference_tpu_torch.runtime import autonomous as tauto
from min_llm_inference_tpu_torch.runtime import graph as tgraph
from min_llm_inference_tpu_torch.utils import profiling

torch.set_num_threads(1)

REF = T.ModelConfig(n_vocab=256, emb_dim=32, n_seq=64, eof_token_id=255)
DEEP = T.ModelConfig(n_vocab=256, emb_dim=32, n_seq=64, n_layers=2,
                     n_heads=2, ffn_dim=64, use_output_proj=True,
                     use_layernorm=True, eof_token_id=255)
CASES = {
    "ref": (REF, dict(kv_dtype="int4", decode_ring=False, subbursts=2)),
    "ring": (DEEP, dict(kv_dtype="int8", decode_ring=True, attn_dgrid=True,
                        sort_admits=True)),
}
DEVICE_PHASES = ("burst", "admit", "prefill", "ring", "logits")


def numpy_tree(model, seed):
    """Uniform(-1, 1) * 0.02 weights with an EOF bias."""
    rng = np.random.default_rng(seed)
    D, F = model.emb_dim, model.ffn_dim

    def u(*shape):
        return (rng.uniform(-1, 1, shape) * 0.02).astype(np.float32)

    wte = u(model.n_vocab, D)
    wte[model.eof_token_id] += 0.05
    layers = []
    for _ in range(model.n_layers):
        layer = {k: u(D, D) for k in ("wq", "wk", "wv")}
        if model.use_output_proj:
            layer["wo"] = u(D, D)
        if F:
            layer.update(w_up=u(D, F), w_down=u(F, D))
        if model.use_layernorm:
            layer.update(ln1_g=np.ones(D, np.float32),
                         ln2_g=np.ones(D, np.float32))
        layers.append(layer)
    return {"wte": wte, "wpe": u(model.n_seq, D), "layers": layers}


def engine(case, device="cpu", **kw):
    model, extra = CASES[case]
    params = T.params_from_numpy(numpy_tree(model, 0), model, device=device)
    cfg = T.EngineConfig(**{**dict(n_slots=16, page_size=16, n_pages=64,
                                   n_forward_rounds=4), **extra})
    return T.AutonomousEngine(params, model, cfg, device=device,
                              max_new_per_burst=8, bursts_per_chunk=2, **kw)


def prompts_for(seed, n, plen=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, int(rng.integers(1, plen))).tolist()
            for _ in range(n)]


def store_of(prompts):
    store = T.ItemStorage()
    for i, p in enumerate(prompts):
        store.add_new_item(T.Request(i, list(p)))
    return store


@contextlib.contextmanager
def tracing(on):
    prev = profiling.set_tracing(on)
    try:
        yield
    finally:
        profiling.set_tracing(prev)


@pytest.fixture
def stats():
    s = profiling.get_global_phase_stats()
    s.reset()
    yield s
    s.reset()


# ------------------------------------------------------------ device spans


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_phase_under_capture(stats, on):
    """Under a capture a phase records no host time; with tracing off it
    launches no stamp, with tracing on a start and an end stamp on its
    phase's row of the table, around its region."""
    table = torch.zeros(profiling.MAX_DEVICE_PHASES,
                        profiling.DEVICE_COLUMNS, dtype=torch.int64)
    stamps = []

    def stamp(row, end):
        stamps.append((row.data_ptr(), end))

    with tracing(on), profiling.capturing(table, stamp):
        with profiling.phase("unit_outer"):
            stamps.append("body")
            with profiling.phase("unit_inner"):
                pass
    assert "unit_outer" not in stats.seconds
    assert "unit_inner" not in stats.seconds
    if not on:
        assert stamps == ["body"]
        return
    rows = {n: table[profiling._device_rows[n]].data_ptr()
            for n in ("unit_outer", "unit_inner")}
    assert stamps == [(rows["unit_outer"], False), "body",
                      (rows["unit_inner"], False), (rows["unit_inner"], True),
                      (rows["unit_outer"], True)]


def test_phase_outside_capture_keeps_host_time(stats):
    """Outside a capture, tracing on or off, a phase is a host range with
    host seconds and no device time."""
    for on in (False, True):
        with tracing(on), profiling.phase("unit_host"):
            pass
    assert stats.calls["unit_host"] == 2
    assert "unit_host" not in stats.device_seconds


def test_fold_device_table(stats):
    """A device table read to the host adds each stamped phase's summed
    nanoseconds and calls as device seconds beside the host seconds; rows
    with no call add nothing."""
    rows = {n: profiling._device_row(n) for n in ("unit_a", "unit_b")}
    table = np.zeros((profiling.MAX_DEVICE_PHASES, profiling.DEVICE_COLUMNS),
                     np.int64)
    table[rows["unit_a"]] = (123, 2_500_000_000, 7)
    stats.add("unit_a", 0.25)
    profiling.fold_device(table)
    profiling.fold_device(table)
    assert stats.device_seconds["unit_a"] == pytest.approx(5.0)
    assert stats.device_calls["unit_a"] == 14
    assert "unit_b" not in stats.device_seconds
    s = stats.summary()["unit_a"]
    assert s["seconds"] == 0.25 and s["calls"] == 1
    assert s["device_seconds"] == pytest.approx(5.0)
    assert s["device_calls"] == 14


def test_cpu_run_times_burst_phases_on_the_host(stats):
    """On the CPU the burst runs eagerly: its phases and the run's host
    phases are host ranges, and nothing is timed on the device."""
    eng = engine("ring")
    with tracing(True):
        eng.run(store_of(prompts_for(1, 20)))
    for name in DEVICE_PHASES + ("queue", "upload", "burst_dispatch",
                                 "status_fetch", "drain_fetch", "collect"):
        assert stats.calls[name] > 0, name
    assert not stats.device_seconds


# ------------------------------------------------------- slot-round counter


@pytest.mark.parametrize("case", list(CASES))
def test_slot_round_counters(case, monkeypatch):
    """With a drain floor below n_slots: slot_rounds is the sum of width x
    rounds over the executed bursts, below rounds x n_slots once the drain
    narrows, and above the tokens served (each live slot-round emits one
    token; some slots idle)."""
    eng = engine(case, min_drain_slots=8)
    assert eng._widths() == [16, 8]
    prompts = prompts_for(2, 40)
    seen = []
    real = tauto._Program.burst

    def spy(prog, b):
        r0 = int(prog.counts[tauto._ROUNDS])
        out = real(prog, b)
        seen.append((b, int(prog.counts[tauto._ROUNDS]) - r0))
        return out

    monkeypatch.setattr(tauto._Program, "burst", spy)
    store = store_of(prompts)
    eng.run(store)
    st = eng.stats
    served = sum(len(store.finished[i].tokens) - len(p)
                 for i, p in enumerate(prompts))
    assert {b for b, r in seen if r} == {16, 8}
    assert st.rounds == sum(r for _, r in seen)
    assert st.slot_rounds == sum(b * r for b, r in seen)
    assert st.slot_rounds < st.rounds * eng.engine_cfg.n_slots
    assert 0 < served < st.slot_rounds


# -------------------------------------------------------- admission waits


@pytest.fixture
def counter():
    c = get_global_throughput_counter()
    c.reset()
    yield c
    c.reset()


def serve_session(eng, prompts, batches=4):
    """Submit ``prompts`` in waves between steps and collect them all;
    returns {id: (before submit, after submit)}, {id: after its poll}."""
    sess = T.StreamingSession(eng, capacity=64, max_prompt_len=32)
    submitted, finished = {}, {}
    waves = np.array_split(np.arange(len(prompts)), batches)
    for wave in waves:
        reqs = [T.Request(int(i), list(prompts[i])) for i in wave]
        t0 = time.perf_counter()
        sess.submit(reqs)
        t1 = time.perf_counter()
        submitted.update((r.id, (t0, t1)) for r in reqs)
        s = sess.step(observe=True)
        for r in sess.poll(s["fin_lens"], s["n_submitted_at"]):
            finished[r.id] = time.perf_counter()
    for r in sess.close():
        finished[r.id] = time.perf_counter()
    assert len(finished) == len(prompts)
    return submitted, finished


def test_session_request_spans(stats, counter):
    """Every collected request has one admission wait in the
    ThroughputCounter, from its submit to a read no later than the poll
    that handed it over (requests are admitted, and noted, in submission
    order); the session's reads and its hand-back are program phases."""
    prompts = prompts_for(3, 40)
    submitted, finished = serve_session(engine("ref"), prompts)
    waits = list(counter.ttfts)
    assert len(waits) == len(prompts)
    for k, wait in enumerate(waits):
        t0, t1 = submitted[k]
        assert 0 <= wait <= finished[k] - t0
    # a wave waits at least one chunk for the slots the first one holds
    assert max(waits) > min(waits)
    for name in ("submit", "burst_dispatch", "status_fetch", "poll_fetch",
                 "collect"):
        assert stats.calls[name] > 0, name


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_session_admission_waits_need_no_tracing(counter, on):
    """The admission waits are noted whether the program's tracing is on
    or off, each request's once."""
    prompts = prompts_for(4, 24)
    with tracing(on):
        serve_session(engine("ref"), prompts)
    assert len(counter.ttfts) == len(prompts)
    assert not counter._submit_times


def test_session_pipelined_reads_admit(counter):
    """dispatch/observe reads bring the queue head too: every request
    served through them has its admission wait noted."""
    prompts = prompts_for(5, 20)
    sess = T.StreamingSession(engine("ref"), capacity=32, max_prompt_len=32)
    sess.submit([T.Request(i, list(p)) for i, p in enumerate(prompts)])
    got = []
    for _ in range(200):
        sess.dispatch()
        s = sess.observe()
        if s is not None:
            got += sess.poll(s["fin_lens"], s["n_submitted_at"])
        if len(got) == len(prompts):
            break
    got += sess.close()
    assert len(got) == len(prompts)
    assert len(counter.ttfts) == len(prompts)
    assert not counter._submit_times


# --------------------------------------------------------- first-token times


def test_run_notes_first_tokens_at_admission_reads():
    """``run`` notes each request's first token at the status read that
    shows it admitted: every time lies inside the batch (submit to the end
    of run), and with a queue that outlasts one chunk some lie well before
    its end."""
    eng = engine("ref")
    prompts = prompts_for(6, 60)
    counter = get_global_throughput_counter()
    counter.reset()
    t0 = time.perf_counter()
    store = store_of(prompts)
    eng.run(store)
    wall = time.perf_counter() - t0
    ttfts = list(counter.ttfts)
    counter.reset()
    assert len(ttfts) == len(prompts)
    assert max(ttfts) <= wall
    assert eng.stats.bursts > eng.chunk
    assert min(ttfts) < max(ttfts)


# ------------------------------------------------------- bench.py's view

TINY = ["--dtype", "float32", "--slots", "8", "--pages", "64", "--seq",
        "32", "--emb", "64", "--vocab", "64", "--requests", "24",
        "--repeats", "2", "--rounds", "4", "--page-size", "8",
        "--device", "cpu"]


@pytest.mark.parametrize("flag", [[], ["--phase-stats"]],
                         ids=["plain", "phase-stats"])
def test_bench_phase_stats_traces(monkeypatch, capsys, flag):
    """``--phase-stats`` runs the bench with the program's tracing on and
    prints the phases of the last timed run, the burst's among them (host
    seconds on the CPU, where nothing is captured); the switch is off again
    afterwards, and without the flag it stays off."""
    seen = []
    real = tauto.AutonomousEngine.run

    def run(self, store):
        seen.append(profiling.tracing())
        return real(self, store)

    monkeypatch.setattr(tauto.AutonomousEngine, "run", run)
    capsys.readouterr()
    assert tbench.main(TINY + flag) == 0
    assert seen == [bool(flag)] * 3
    assert not profiling.tracing()
    err = [json.loads(x) for x in capsys.readouterr().err.splitlines()
           if x.startswith("{")]
    if not flag:
        assert err == []
        return
    phases = err[0]["phase_stats"]
    for name in ("queue", "upload", "burst", "admit", "prefill", "logits",
                 "burst_dispatch", "status_fetch", "drain_fetch", "collect"):
        assert phases[name]["calls"] > 0, name
        assert "device_seconds" not in phases[name]


# ------------------------------------------------------------- on the card


def count_stamps(path: str) -> int:
    with open(path) as f:
        text = f.read()
    return len(set(re.findall(
        r'"(graph_\d+_node_\d+)"\s*\[[^\]]*phase_stamp_kernel', text)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_graph_stamps(cuda, case, tmp_path, monkeypatch, stats):
    """A graph captured with tracing off holds no stamp kernel and the
    nodes of the one captured with tracing on, less two stamps per region
    its capture entered; the traced run's device seconds nest inside
    ``burst`` and its tokens are the untraced run's."""
    prompts = prompts_for(7, 40)
    stamped = []
    real = tgraph._stamp

    def spy(row, end):
        stamped.append(end)
        real(row, end)

    monkeypatch.setattr(tgraph, "_stamp", spy)
    nodes, tokens = {}, {}
    for on in (False, True):
        dot_dir = tmp_path / ("on" if on else "off")
        os.makedirs(dot_dir)
        eng = engine(case, device=cuda, min_drain_slots=8,
                     _graph_dot_dir=str(dot_dir))
        stamped.clear()
        with tracing(on):
            store = store_of(prompts)
            eng.run(store)
        tokens[on] = [store.finished[i].tokens for i in range(len(prompts))]
        for b in eng._widths():
            path = str(dot_dir / f"burst-{b}.dot")
            nodes[on, b] = (tgraph.count_dot_nodes(path), count_stamps(path))
        n_stamps = len(stamped)
        assert n_stamps == (2 * stamped.count(True) if on else 0)
    assert tokens[True] == tokens[False]
    for b in eng._widths():
        assert nodes[False, b][1] == 0
    assert sum(nodes[True, b][1] for b in eng._widths()) == n_stamps
    assert (sum(nodes[True, b][0] - nodes[False, b][0]
                for b in eng._widths()) == n_stamps)
    dev = stats.device_seconds
    assert dev["burst"] > 0
    inside = ("admit", "prefill", "logits") + (
        ("ring",) if case == "ring" else ())
    assert set(dev) == {"burst", *inside}
    assert sum(dev[n] for n in inside) <= dev["burst"]
    assert stats.device_calls["burst"] == eng.stats.bursts - eng.stats.skipped
