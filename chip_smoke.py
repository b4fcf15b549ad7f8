#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (min_llm_inference_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --profile DIR      # + a device-time table in DIR

Phases, one line each; any failure raises and exits non-zero:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every kernel from csrc/ (one nvcc per source, in parallel);
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (pool bytes bit-identical, outputs within a stated
     tolerance), and time kernel, plain version and bound;
  4. engine parity on the card at a small float32 config: the kernel path
     (attention_impl="grouped") against the gather oracle ("torch"),
     token for token, for int4, int8 and float32 KV;
  5. the main path at full width, as ``python bench.py`` runs the JAX
     package with no flags: AutonomousEngine, the reference-parity model
     (1 layer, 1 head, emb 2048, vocab 1024, n_seq 128, bf16 weights made
     from a numpy seed the bench_params way), int4 paged KV (4096 pages of
     32 rows), 1024 slots, 16 rounds per burst in 2 sub-bursts, 24 bursts
     per status read, no decode ring; 2048 requests with prompts uniform in
     [1, 64]. One warm run (its host syncs counted), one timed run with
     every kernel launch counter set to 0 just before it, and one more run
     whose middle kernel call is copied and replayed: kernel vs plain
     version on real main-path inputs, timed beside its bound.
Then a JSON line of per-kernel numbers and, last, the ok line.

Float32 matmuls run in full float32: TF32 is turned off below.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# the main path, as ``python bench.py`` runs the JAX package with no flags
MAIN = dict(n_vocab=1024, emb_dim=2048, n_seq=128, page_size=32,
            n_slots=1024, n_pages=4096, requests=2048)


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 3


def grouped_case(rng, dev, B, W, P, D, H, kv, in_dtype, NP=None):
    """Random fused-write inputs in the engine's layout: contiguous page
    groups, q/k_new/v_new as column slices of one fused [B, 3D] projection,
    scales already updated for fresh pages, lengths covering dead slots, 1,
    P-1, P, P+1, fresh-page inserts and the last position."""
    from min_llm_inference_tpu_torch.models.paged import decode_fresh_pid
    from min_llm_inference_tpu_torch.ops.quant import (
        kv_qmax,
        update_page_scales,
    )

    NP = NP or (B + 3) * W
    NG = NP // W
    packed = kv == "int4"
    Dk = D // 2 if packed else D
    gids = rng.permutation(NG)[:B]
    table = (gids[:, None] * W + np.arange(W)[None, :]).astype(np.int32)
    lengths = rng.integers(1, W * P + 1, B).astype(np.int32)
    lengths[rng.random(B) < 0.1] = 0
    special = [s for s in (0, 1, P - 1, P, P + 1, 2 * P + 1, W * P, 0,
                           (W - 1) * P + 1) if s <= W * P][:B]
    lengths[: len(special)] = special
    if kv == "int4":
        hi = rng.integers(-7, 8, (NP, 2, P, Dk))
        lo = rng.integers(-7, 8, (NP, 2, P, Dk))
        pool = (16 * hi + lo).astype(np.int8)
    elif kv == "int8":
        pool = rng.integers(-127, 128, (NP, 2, P, Dk)).astype(np.int8)
    else:
        pool = rng.standard_normal((NP, 2, P, Dk)).astype(np.float32)
    qkv = torch.from_numpy(
        rng.standard_normal((B, 3 * D)).astype(np.float32)).to(dev, in_dtype)
    t = {"q": qkv[:, :D], "k_new": qkv[:, D:2 * D], "v_new": qkv[:, 2 * D:],
         "kw": dict(n_heads=H, packed_int4=packed)}
    t["pool"] = torch.from_numpy(pool).to(dev)
    t["lengths"] = torch.from_numpy(lengths).to(dev)
    t["table"] = torch.from_numpy(table).to(dev)
    if kv == "float32":
        t["ks"] = t["vs"] = None
    else:
        qmax = kv_qmax(packed)
        live = t["lengths"] > 0
        pos = torch.clamp_min(t["lengths"] - 1, 0)
        fresh = decode_fresh_pid(t["table"], pos, live, P, NP)
        for side, new in (("ks", "k_new"), ("vs", "v_new")):
            s = torch.from_numpy(
                (rng.random(NP) * 0.05 + 0.001).astype(np.float32)).to(dev)
            t[side] = update_page_scales(s, t[new], fresh, qmax)
    return t


def grouped_bound(live_lens, calls, B, D, Dk, W, P, in_bytes, pool_bytes,
                  scaled) -> tuple:
    """The least time in ms of ``calls`` fused-write calls over B slots
    whose live slot-calls had the context lengths ``live_lens`` (all calls
    together): the bytes that must move (each input read once, each output
    written once) over HBM bandwidth, or the f32 operations over the f32
    peak, whichever is larger. Returns (ms, "bytes" or "operations")."""
    lens = np.asarray(live_lens, dtype=np.int64)
    rows = int(lens.sum())                      # context rows per side
    pages = int(np.ceil(lens / P).sum())
    nbytes = (
        3 * lens.size * D * in_bytes            # q, k_new, v_new of live slots
        + 2 * rows * Dk * pool_bytes            # K, V rows read; new rows written
        + (2 * pages * 4 if scaled else 0)      # page scales
        + calls * (B * D * 4 + B * 4 + B * W * 4)  # o written; lengths, table
    )
    ops = 4 * rows * D                          # q.K and p.V multiply-adds
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def grouped_bound_ms(t) -> tuple:
    """grouped_bound of one call on the inputs ``t``."""
    B, D = t["q"].shape
    _, _, P, Dk = t["pool"].shape
    lens = t["lengths"].cpu().numpy()
    return grouped_bound(lens[lens > 0], 1, B, D, Dk, t["table"].shape[1], P,
                         t["q"].element_size(), t["pool"].element_size(),
                         t["ks"] is not None)


def check_grouped(name, t, timed, tol=1e-4):
    """Kernel vs plain version on identical inputs ``t`` (grouped_case, or
    a main-path round). Pool bytes must be bit-identical; o must agree
    within tol*max(1, |o|max) (float32 sums in another order). Mode (a),
    without the insert, is checked on the written pool."""
    from min_llm_inference_tpu_torch.ops.paged_attention_grouped import (
        paged_decode_attention_grouped as kernel,
        paged_decode_attention_grouped_plain as plain,
    )

    args = (t["lengths"], t["table"], t["ks"], t["vs"], t["k_new"], t["v_new"])
    kw = t["kw"]
    pool_p, pool_k = t["pool"].clone(), t["pool"].clone()
    o_p, _ = plain(t["q"], pool_p, *args, **kw)
    o_k, _ = kernel(t["q"], pool_k, *args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(pool_p, pool_k):
        bad = (pool_p != pool_k).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: pool bytes differ at {bad}")
    if torch.any(o_k[t["lengths"] == 0] != 0):
        raise AssertionError(f"{name}: dead slots not exactly zero")
    err = (o_k - o_p).abs().max().item()
    lim = tol * max(1.0, o_p.abs().max().item())
    if not err <= lim:
        raise AssertionError(f"{name}: max |o_kernel - o_plain| {err} > {lim}")
    o_a = kernel(t["q"], pool_k, *args[:4], **kw)
    o_ap = plain(t["q"], pool_k, *args[:4], **kw)
    err_a = (o_a - o_ap).abs().max().item()
    if not err_a <= lim:
        raise AssertionError(f"{name}: mode (a) max err {err_a} > {lim}")
    res = {"max_abs_err": max(err, err_a)}
    if timed:
        res["ms"] = time_ms(lambda: kernel(t["q"], pool_k, *args, **kw), 20)
        res["plain_ms"] = time_ms(
            lambda: plain(t["q"], pool_p, *args, **kw), 5, warmup=1)
        res["bound_ms"], res["bound_by"] = grouped_bound_ms(t)
        lens = t["lengths"].cpu().numpy()
        res["live_slots"] = int((lens > 0).sum())
        res["mean_live_len"] = float(lens[lens > 0].mean())
    log("kernel", case=name, pool_bytes="identical", **{
        k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in res.items()})
    return res


# ---------------------------------------------------------------- phases 4-5


def numpy_init_params(rng, V, D, S, eof, eof_bias):
    """Uniform(-1, 1) * 0.02 weights with an EOF bias: the recipe of the JAX
    package's init_params, drawn from a numpy generator."""
    def u(shape):
        return (rng.uniform(-1.0, 1.0, shape) * 0.02).astype(np.float32)

    wte = u((V, D))
    wte[eof] += eof_bias
    return {"wte": wte, "wpe": u((S, D)),
            "layers": [{"wq": u((D, D)), "wk": u((D, D)), "wv": u((D, D))}]}


def bench_params(rng, V, D, S, eof):
    """bench.py's weights: uniform(0, 1), the EOF row scaled by 1.0001."""
    wte = rng.random((V, D), dtype=np.float32)
    wte[eof] *= 1.0001
    return {"wte": wte, "wpe": rng.random((S, D), dtype=np.float32),
            "layers": [{"wq": rng.random((D, D), dtype=np.float32),
                        "wk": rng.random((D, D), dtype=np.float32),
                        "wv": rng.random((D, D), dtype=np.float32)}]}


def make_store(T, prompts):
    store = T.ItemStorage()
    for i, p in enumerate(prompts):
        store.add_new_item(T.Request(i, list(p)))
    return store


def engine_parity(T, dev):
    model = T.ModelConfig(n_vocab=256, emb_dim=32, n_seq=64, eof_token_id=255)
    params = T.params_from_numpy(
        numpy_init_params(np.random.default_rng(1), 256, 32, 64, 255, 0.05),
        model, dev)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 255, int(rng.integers(1, 24))).tolist()
               for _ in range(24)]
    for kv in ("int4", "int8", "float32"):
        cfg = T.EngineConfig(n_slots=8, page_size=16, n_pages=32,
                             n_forward_rounds=4, subbursts=2, kv_dtype=kv,
                             decode_ring=False)
        outs = {}
        for impl in ("grouped", "torch"):
            store = make_store(T, prompts)
            T.AutonomousEngine(params, model, cfg, attention_impl=impl,
                               device=dev).run(store)
            outs[impl] = [store.finished[i].tokens for i in range(len(prompts))]
        if outs["grouped"] != outs["torch"]:
            first = next(i for i in range(len(prompts))
                         if outs["grouped"][i] != outs["torch"][i])
            raise AssertionError(f"engine parity {kv}: request {first} "
                                 f"{outs['grouped'][first]} vs "
                                 f"{outs['torch'][first]}")
        n_gen = sum(len(o) - len(p) for o, p in zip(outs["grouped"], prompts))
        log("engine", kv=kv, requests=len(prompts), generated=n_gen,
            tokens="grouped == torch")


def main_path(T, dev, gpu_line, profile_dir=None):
    from min_llm_inference_tpu_torch.ops.paged_attention_grouped import (
        paged_decode_attention_grouped as kernel,
    )

    V, D, S = MAIN["n_vocab"], MAIN["emb_dim"], MAIN["n_seq"]
    n_req = MAIN["requests"]
    model = T.ModelConfig(n_vocab=V, emb_dim=D, n_seq=S, eof_token_id=V - 1,
                          dtype="bfloat16")
    cfg = T.EngineConfig(n_slots=MAIN["n_slots"], n_pages=MAIN["n_pages"],
                         n_forward_rounds=16, page_size=MAIN["page_size"],
                         init_num_pages=2, kv_dtype="int4",
                         max_prefill_batch=128, decode_ring=False,
                         subbursts=2)
    params = T.params_from_numpy(
        bench_params(np.random.default_rng(0), V, D, S, V - 1), model, dev)

    def prompts(n, seed):
        rng = np.random.default_rng(seed)
        return [rng.integers(0, V - 1, int(rng.integers(1, 65))).tolist()
                for _ in range(n)]

    def run(n, seed, count_syncs=False):
        store = make_store(T, prompts(n, seed))
        eng = T.AutonomousEngine(params, model, cfg, attention_impl="grouped",
                                 max_new_per_burst=512, bursts_per_chunk=24,
                                 request_capacity=n_req, device=dev)
        T.get_global_throughput_counter().reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if count_syncs:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    eng.run(store)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            sites = collections.Counter(
                (w.filename, w.lineno) for w in seen
                if "synchroniz" in str(w.message))
            pkg = os.path.dirname(T.__file__)
            eng.syncs_seen = sum(n for (f, _), n in sites.items()
                                 if f.startswith(pkg))
            eng.sync_sites = ",".join(
                f"{os.path.relpath(f, HERE) if f.startswith(HERE) else f}"
                f":{ln}x{n}" for (f, ln), n in sites.items())
        else:
            eng.run(store)
        torch.cuda.synchronize()
        return eng, store, time.perf_counter() - t0

    # warm: cuBLAS handles, allocator pools, kernel library. PyTorch's sync
    # debug mode sees every sync of the run; the engine must account for
    # each one made from the package's code (all sites are printed).
    warm, _, _ = run(64, seed=1, count_syncs=True)
    log("syncs", requests=64, bursts=warm.stats.bursts,
        engine_count=warm.stats.host_syncs, seen_in_package=warm.syncs_seen,
        sites=warm.sync_sites)
    if warm.syncs_seen != warm.stats.host_syncs:
        raise AssertionError(f"{warm.syncs_seen} device syncs in the run, "
                             f"the engine accounts for "
                             f"{warm.stats.host_syncs}")
    kernel.launches = 0
    eng, store, wall = run(n_req, seed=2)
    launches = kernel.launches
    st = eng.stats
    if len(store.finished) != n_req:
        raise AssertionError(f"{len(store.finished)}/{n_req} requests "
                             "finished")
    total = 0
    for req in store.finished.values():
        gen = req.tokens[req.prompt_len:]
        if not gen or len(req.tokens) > S or not all(0 <= x < V for x in gen):
            raise AssertionError(f"request {req.id}: bad output {gen[:8]}")
        total += len(gen)
    if launches != st.rounds * model.n_layers or launches == 0:
        raise AssertionError(f"kernel launches {launches} != rounds "
                             f"{st.rounds} x layers {model.n_layers}")
    # the kernel's bound over the whole run, from the contexts its calls
    # saw: a request is live in the calls at lengths plen .. final-1
    ctx = np.concatenate([np.arange(r.prompt_len, len(r.tokens))
                          for r in store.finished.values()])
    W = cfg.pages_per_slot(S)
    run_bound, _ = grouped_bound(ctx, launches, cfg.n_slots, D, D // 2, W,
                                 cfg.page_size, 2, 1, True)
    log("main", requests=n_req, generated=total, wall_s=f"{wall:.4f}",
        tok_s=f"{total / wall:.1f}", gpu=f"'{gpu_line}'",
        bursts=st.bursts, skipped=st.skipped, rounds=st.rounds,
        kernel_launches=launches,
        host_syncs_per_burst=f"{st.host_syncs / st.bursts:.3f}",
        mean_live_context=f"{ctx.mean():.2f}",
        mean_live_slots_per_launch=f"{ctx.size / launches:.1f}",
        kernel_bound_ms_per_launch=f"{run_bound / launches:.6g}")
    # one call of that run replayed on its real inputs: kernel vs plain
    call_ix = launches // 2
    res = check_grouped(f"main-path-call-{call_ix}",
                        capture_kernel_inputs(lambda: run(n_req, seed=2),
                                              call_ix), timed=True)
    res["run_bound_ms_per_launch"] = run_bound / launches
    if profile_dir:
        profile_main_path(lambda: run(n_req, seed=2), profile_dir, wall)
    return launches, res


def capture_kernel_inputs(run, call_ix):
    """Run the main path once more with the kernel's call site wrapped and
    return a copy (strides kept) of the inputs of kernel call ``call_ix``,
    taken before that call writes the pool."""
    from min_llm_inference_tpu_torch.models import paged as paged_mod

    real = paged_mod.paged_decode_attention_grouped
    names = ("q", "pool", "lengths", "table", "ks", "vs", "k_new", "v_new")
    calls, snap = [0], {}

    def copy(x):
        if x is None:
            return None
        y = torch.empty_strided(x.size(), x.stride(), dtype=x.dtype,
                                device=x.device)
        return y.copy_(x)

    def wrapped(*args, **kw):
        if calls[0] == call_ix:
            snap.update({k: copy(a) for k, a in zip(names, args)}, kw=kw)
        calls[0] += 1
        return real(*args, **kw)

    paged_mod.paged_decode_attention_grouped = wrapped
    try:
        run()
    finally:
        paged_mod.paged_decode_attention_grouped = real
    if not snap:
        raise AssertionError(f"the replay made {calls[0]} kernel calls, "
                             f"none at index {call_ix}")
    return snap


def profile_main_path(run, out_dir, wall_unprofiled):
    """One more main-path run under torch.profiler: device time by kernel
    (device-side kernel and copy events only: the CPU ops and the phase
    ranges also carry device time and would count it twice) and the sum's
    share of the profiled and of the unprofiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = run()
    phases ={"burst_dispatch", "status_fetch", "drain_fetch"}
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key in phases:
            continue
        us = getattr(e, "self_device_time_total", 0)
        if us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    with open(os.path.join(out_dir, "main_path_kernels.txt"), "w") as f:
        for us, key, count in rows:
            f.write(f"{us / 1e3:12.3f} ms {count:8d}  {key}\n")
    log("profile", wall_s=f"{wall:.4f}", device_busy_s=f"{busy_s:.4f}",
        busy_share=f"{busy_s / wall:.4f}",
        busy_share_of_unprofiled=f"{busy_s / wall_unprofiled:.4f}",
        top=";".join(f"{k[:48]}={us / 1e3:.2f}ms/{n}"
                     for us, k, n in rows[:8]))


# ---------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="also profile one main-path run into DIR")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import min_llm_inference_tpu_torch as T
    from min_llm_inference_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(gpu_line, flush=True)
    log("device", name=f"'{torch.cuda.get_device_name(0)}'",
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, tf32="off")

    t0 = time.perf_counter()
    took = _build.build()
    for src in _build.SOURCES:
        with open(_build.library_path(src) + ".log") as f:
            ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
        log("build", source=src, nvcc_s=f"{took.get(src, 0.0):.2f}",
            ptxas=f"'{' | '.join(ptxas[:4])}'")
    log("build", total_s=f"{time.perf_counter() - t0:.2f}")

    rng = np.random.default_rng(0)
    # the main path's shapes: 1024 slots, W = 4 pages of 32 rows, 4096
    # pages, emb 2048, one head, bf16 projections
    P = MAIN["page_size"]
    shape = (MAIN["n_slots"], -(-MAIN["n_seq"] // P), P, MAIN["emb_dim"], 1)
    main4 = check_grouped("main-int4", grouped_case(
        rng, dev, *shape, "int4", torch.bfloat16, NP=MAIN["n_pages"]),
        timed=True)
    main8 = check_grouped("main-int8", grouped_case(
        rng, dev, *shape, "int8", torch.bfloat16, NP=MAIN["n_pages"]),
        timed=True)
    errs = [main4["max_abs_err"], main8["max_abs_err"]]
    for kv in ("int4", "int8", "float32"):
        for in_dtype in (torch.float32, torch.bfloat16):
            r = check_grouped(f"small-H2-{kv}-{str(in_dtype)[6:]}",
                              grouped_case(rng, dev, 8, 2, 16, 32, 2, kv,
                                           in_dtype), timed=False)
            errs.append(r["max_abs_err"])
    r = check_grouped("odd-dh-int4", grouped_case(
        rng, dev, 5, 3, 8, 36, 3, "int4", torch.float32), timed=False)
    errs.append(r["max_abs_err"])

    engine_parity(T, dev)
    # ms, plain_ms and bound_ms: one call of the main path replayed on its
    # real inputs
    launches, ref = main_path(T, dev, gpu_line, args.profile)
    errs.append(ref["max_abs_err"])

    print(json.dumps({"kernels": [{
        "name": "paged_decode_attention_grouped",
        "route": "cuda",
        "source": "min_llm_inference_tpu_torch/csrc/paged_attention_grouped.cu",
        "replaces": "min_llm_inference_tpu/ops/paged_attention_grouped.py:645",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": ref["ms"],
        "plain_ms": ref["plain_ms"],
        "bound_ms": ref["bound_ms"],
        "bound_by": ref["bound_by"],
        "library_ms": None,
        "mean_live_len": ref["mean_live_len"],
        "live_slots": ref["live_slots"],
        "run_bound_ms_per_launch": ref["run_bound_ms_per_launch"],
        "random_int4_ms": main4["ms"],
        "random_int4_bound_ms": main4["bound_ms"],
        "random_int8_ms": main8["ms"],
        "random_int8_bound_ms": main8["bound_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
