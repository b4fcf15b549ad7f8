#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (min_llm_inference_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --profile DIR      # + device-time tables in DIR
    python3 chip_smoke.py --only bf16-kv     # the build and [bf16-kv] alone
    python3 chip_smoke.py --only bench       # the build and [bench] alone
    python3 chip_smoke.py --only quality     # the build and [quality] alone
    python3 chip_smoke.py --only prefill-attn  # its kernel's build and
                                             # [prefill-attn] alone
    python3 chip_smoke.py --only deepseek    # [deepseek]: the latent decode,
                                             # prefill-192 and expert kernels,
                                             # DeepSeek-V2-Lite whole

Phases, one line each; any failure raises and exits non-zero:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every kernel from csrc/ (one nvcc per source, in parallel) and
     the native host scheduler (one c++, in parallel with them); then
     [deepseek] (deepseek_phase), while the card is still empty: the
     latent decode, 192 / 128 prefill and grouped expert kernels at the
     deepseek-v2-lite cell's shapes against their plain versions, then
     the model whole with its syncs and each counted kernel's launches
     (their entries in the kernels line);
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes of the path that runs it (pool bytes bit-identical, partials
     and outputs within a stated tolerance), and time kernel, plain version
     and bound: the fused-write grouped kernel at the reference path's
     shapes; its ring-partial mode (c), the dgrid partial, the ring flush
     and the int8 prefill scatter at the gpt2s path's shapes; the one-slot
     kernel and the prefill scatter at the host path's shapes (1024 slots,
     emb 2048, a fragmented table with stale dead rows; [128, 128, 2048]
     prefill blocks); the causal prefill attention ([prefill-attn]) at
     the gpt2-small cells' prefill blocks (64 prompts of 512-896 tokens
     padded to 1024, and of 16-128 padded to 128; 12 heads of 64), at its
     tile edges and at every head dim it takes: float32 output within 2e-5
     of each (row, head)'s scale, bfloat16 within one ulp, zeros past the
     length, timed beside its bound, its plain version and
     scaled_dot_product_attention (a yardstick the port never calls);
     and the one-slot kernel on small multi-head f32
     pools; the flat ring partial at the gpt2s shapes (int8, 12 heads) and
     at the reference ring's (packed int4, emb 2048), and on small f32,
     int8 and int4 pools with 1, 2 and 12 heads, overcommit's half-group
     tables and dead rows with a stale ring_start; both ring-partial kernels
     at their edges: 12-head contexts of W*P = 1024 (flat, int8 and int4)
     and 8192 (dgrid) with a slot at ring_start = W*P, the drained 512
     slots, 61 slots, every slot dead, fragmented and half-group tables
     (flat); the int4 probe's kernel through its entry point (``python -m
     min_llm_inference_tpu_torch.tools.int4_probe`` runs it alone); the
     one-slot and the grouped kernel (modes a, b, c) at their edges:
     12-head contexts of W*P = 4096 (int8; int4 for the grouped modes),
     rows of 8192 features in one head, the fused write with the new row
     at every position class of a tile and a page, five times over one
     pool; and copies against in-block arithmetic (``[split]``): the
     device time of the one-slot kernel and of the fused write at one head
     of 2048 features beside builds of the same source that only copy
     (RING_PARTIAL_SPLIT=1) or only compute (=2), in turns; the sampling
     kernel ([sample]) on float32 logits of the reference path's width
     ([1024, 1024]) and of GPT-2's vocabulary ([1024, 50257]) with a
     quarter of the rows dead, at temperatures 0.7 and 1.5 and top_k 0
     and 16: its raw draws equal ``random_bits`` bit for bit, its next key
     the plain split's, and its tokens and lengths the plain version's
     (a miss only at a reported near-tie of the two best perturbed scores,
     at most one a call); the same on its edges (sample_edges: ties made
     by the division, all-equal rows, rows of -inf with a few finite
     values, top_k 31, 32, 33 and V - 1 at V 1000 and 1023, top_k 1 and
     V - 1 on rows narrower than a warp, the widths on each side of its
     narrow/wide switch, a wide row's thread parts and whole-row select),
     each live row taking the select it must (candidates above the
     threshold, or the whole row); and its device time with a warp and
     with a block per row at 1024-2048 columns ([sample-switch], the data
     behind the launcher's switch, ops/sampling.narrow_max_v()), and on
     all-equal rows (the whole-row select); the four attention kernels
     at bfloat16 pools (bf16_checks: the grouped modes a, b, c at the
     reference path's shapes, the one-slot kernel at the host path's,
     dgrid and flat at the gpt2s path's, flat at the reference ring's,
     timed beside their bound; the long, wide, odd-head and fused-position
     edges);
  4. engine parity on the card at small configs: the kernel path
     (attention_impl="grouped") against the gather oracle ("torch"),
     token for token: no ring for int4, int8 and float32 KV (reference
     model), and ring decode with dgrid on and off for int8, int4 (mode c)
     and float32 KV (a small gpt2s-shaped model); ring decode on the flat
     partial (f32, int8, int4 KV, 1 and 2 heads) and on the dense view
     (f32, int8, int4); overcommit with forced preemption without the
     ring, with the ring on mode (c) and on the flat partial (f32, int8);
     the host engines' PagedEngine "paged" and "grouped" against "torch"
     for float32, int8 and bfloat16 KV, roomy and preempting, and
     DenseEngine against PagedEngine("torch"); at bfloat16 KV also the
     reference model without the ring and the gpt2s-shaped one with the
     ring on mode (c), dgrid and the flat partial;
  5. the reference path at full width, as ``python bench.py`` runs the JAX
     package with no flags: AutonomousEngine, the reference-parity model
     (1 layer, 1 head, emb 2048, vocab 1024, n_seq 128, bf16 weights made
     from a numpy seed the bench_params way), int4 paged KV (4096 pages of
     32 rows), 1024 slots, 16 rounds per burst in 2 sub-bursts, 24 bursts
     per status read, no decode ring; 2048 requests with prompts uniform in
     [1, 64]. The engine runs each burst as one CUDA graph (the liveness
     gate and the prefill bucket as IF nodes), captured in its first run.
     One warm run of 64 requests (the capture: one [graph] line per width
     with capture and instantiate seconds, pool bytes and node count; its
     host syncs counted: two uploads, one status read per chunk, the final
     pull), one timed run that replays the graph, with every kernel launch
     counter set to 0 just before it (a replay counts its launches on the
     device), and the same request stream on the eager path (which reads
     the gate and the bucket on the host): its tokens must equal the
     graph's ([graph] line with both walls), and its middle kernel call is
     copied and replayed: kernel vs plain version on real inputs, timed
     beside its bound;
  6. the gpt2s path at full width, as ``python bench.py --model gpt2s``
     runs the JAX package: the 12-layer GPT-2-small-class model (emb 768,
     12 heads, FFN 3072, pre-LN, output projection, bf16 weights:
     bench.py's own, init_params(0), made on the card; phase 13), int8
     paged KV (4096 pages of 32 rows), 1024 slots, 16 rounds per burst
     with a per-burst decode ring, the dgrid partial, sort_admits, 6
     bursts per status read and the drain downshift to 512 slots; 2048
     requests with prompts uniform in [1, 64]. The warm run, timed run
     and eager run of phase 5: the eager run's
     middle call of each kernel is copied and replayed against the plain
     version;
  7. the host path at full width, as ``python bench.py --engine host
     --attention pallas`` runs the JAX package: PagedEngine (Python page
     scheduler, two-deep pipelined loop) on the one-slot kernel, phase 5's
     model and request stream with int8 paged KV. A warm run of 64
     requests (no sync from the package but the one pull per iteration),
     one timed run with every launch counter set to 0 just before it, one
     replay run whose middle one-slot and prefill calls are replayed
     against the plain versions, and one NativePagedEngine run on the same
     stream whose outputs must equal the timed run's token for token;
  8. the flat path at full width, as ``python bench.py --ring`` runs the
     JAX package with ``attn_flat``: phase 5's model and request stream
     with int4 KV, the decode ring carried across 2 sub-bursts and flushed
     once per burst, and the flat ring partial. The warm, timed and eager
     runs of phase 5 (flat launches = rounds, one flush per executed burst,
     no other attention kernel); the eager run's middle flat and flush
     calls are replayed against the plain versions;
  9. the overcommit path at full width, as ``python bench.py --overcommit
     --pages 3072`` runs the JAX package: phase 5's model and request
     stream with int8 KV, no ring, 2 sub-bursts, half-group grants (1536
     half-units for 1024 slots whose requests mostly need two), growth
     and youngest-first preemption. The warm, timed (it must preempt) and
     eager runs of phase 5, and a replay of the eager run's middle
     fused-write call;
 10. the stream path: StreamingSession on phase 5's graph engine serves its
     2048 requests in waves of 256 into a ring of 1024 rows, dispatching a
     burst per step and observing each two bursts later; every request
     must equal the one-shot timed run's tokens ([stream] line with the
     wall);
 11. the sampled main path ([main-sample]): phase 5 with temperature 1.5,
     top_k 16 and sample_seed 7, on the reference model with the JAX
     package's init_params(0) weights (on bench.py's uniform(0, 1) weights
     the noise never moves an argmax), the draws made by the sampling
     kernel inside the burst's graph. Its warm run's host syncs must equal the
     greedy main path's; the timed run (launch counters from 0) must
     finish every request with one sampling launch per round; a second
     run with seed 7 must repeat it token for token, a run with seed 8
     must differ, and the eager path must equal the graph; the eager
     run's middle sampling call is replayed against the plain version at
     its width and, with the same live rows, at GPT-2's vocabulary;
     StreamingSession on the sampled engine serves the stream twice with
     one submission pattern, token-identical;
 12. the weights path ([weights]): phase 5 with int8 and then fp8
     weight-only quantized weights (ops/quant.quantize_params), each
     token-exact with a run on the dense bfloat16 tree that
     dequantize_weight makes of the same leaves; both walls beside the
     greedy main path's;
 13. [params]: the port's init_params(0) of bench.py's gpt2s model, made
     on the card and served by phase 6, must have the sha256
     (models.params.params_checksum) of JAX's init_params(PRNGKey(0), ...)
     (GPT2S_INIT_SHA256, recomputed from the JAX package on the CPU by
     tests/test_torch_random.py);
 14. [bf16-kv], bfloat16 KV at full width: phase 5 with
     kv_dtype="bfloat16" (warm, timed and eager runs, the middle
     fused-write call replayed), the host path as ``python bench.py
     --engine host --kv-dtype bfloat16 --rounds 32`` runs the JAX package
     on "grouped" and on "paged" (equal but for near-ties, at most 8
     requests), and the flagship decode step (entry.entry(): 12 layers,
     bf16 KV, 256 slots) on "torch" and on "grouped" (equal but for
     near-ties);
 15. [bench], the port's entry points at full width (bench_phase), before
     any profiler session: ``python -m min_llm_inference_tpu_torch.bench``
     on bench.py's five workloads (no flags, --model gpt2s, --engine host
     --attention pallas, --ring, --overcommit --pages 3072 --warm-requests
     2048) and README.md's --engine host --kv-dtype bfloat16 --rounds 32,
     three timed runs each on the warm run's engine (no capture in a timed
     run of a graphed engine), each JSON line beside this script's own
     path's wall for that configuration; the serving bench closed-loop and
     open-loop at 1000 requests/s; the demo on every backend (parity OK);
     the scaling harness at tp = 1;
 16. [quality], the quantization-quality evidence at full size
     (quality_phase), after [bench] and before any profiler session:
     ``python -m min_llm_inference_tpu_torch.tools.quality_evidence``'s
     8L/512D model trained 1500 steps of 64 sequences on the card (float32,
     TF32 off), its perplexity at float32, int8 and int4 KV and at int8
     weights with int8 KV on 840 x 127 predicted tokens through the paged
     harness, and the 12L/768D GPT-2 import smoke; it must reach ppl_ref <
     15, |int8 ΔPPL| <= 0.1 and a finite smoke. On the trained model's own
     K/V rows (two eval steps, last layer, int8 and int4) the fused-write
     kernel's pool bytes and scales must equal the plain quantizer's and
     its attention the gather oracle's within 1e-4;
 17. the mesh engines (parallel/), after every timed phase, their ranks
     in processes of their own (parallel/launch.run_ranks): [mesh-ref]
     ShardedAutonomousEngine on phase 5's path at world size 1 (NCCL) and
     dp = 2 and 4 on the one card (gloo, share_device; tp = 1, so every
     rank's burst is a CUDA graph), tokens equal to phase 5's timed run;
     [mesh-tp] the gpt2s widths in float32 at tp = 2 and dp = 2 x tp = 2
     (gloo on the one card, eager bursts) against the single-chip engine
     on 256 requests (a differing token must be a near-tie); [mesh-nccl]
     the same across two cards under NCCL where present; [mesh-dryrun]
     ``python -m min_llm_inference_tpu_torch.dryrun 4``. Each mesh line
     has its walls, syncs per burst, graph or eager, and the launches of
     its ranks, each rank's held against its own stats.
With --profile, one more run of each full-width path under torch.profiler
once every path before the mesh has run ([profile] lines, device time by
kernel in DIR/<path>_kernels.txt): a graph with IF nodes captured after a
profiler session faults with an illegal address when replayed under a
later one (tools/graph_profile_repro.py), so no capture follows a
session.
Then a [kernel_device] line per timed check (the kernel's device time alone,
by CUDA events behind a device sleep, device_ev_ms, and from
torch.profiler, device_ms; taken after every path so that the profiler's
cost stays out of the walls; the host path's replayed one-slot call also
gets a device_ev_ms right after its path), a JSON line of per-kernel
numbers (nine kernels, and the four attention kernels again at bf16
pools) and, last, the ok line.

Float32 matmuls run in full float32: TF32 is turned off below.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
INT8_TENSOR_OPS = 1979e12

# the main path, as ``python bench.py`` runs the JAX package with no flags
MAIN = dict(n_vocab=1024, emb_dim=2048, n_seq=128, page_size=32,
            n_slots=1024, n_pages=4096, requests=2048)
# the gpt2s path, as ``python bench.py --model gpt2s`` runs it
GPT2S = dict(n_vocab=1024, emb_dim=768, n_seq=128, n_layers=12, n_heads=12,
             ffn_dim=3072, page_size=32, n_slots=1024, n_pages=4096,
             requests=2048)
# the sha256 of JAX's init_params(PRNGKey(0), ...) of bench.py's gpt2s
# model (bench.gpt2s_model(); models.params.params_checksum;
# tests/test_torch_random.py recomputes it from the JAX package on the CPU)
GPT2S_INIT_SHA256 = (
    "14279b8a512e52850020631dd41b911dafec1b13907117e9b7a267b4ffa79af8")
# the overcommit path's pool, as ``python bench.py --overcommit --pages
# 3072`` sizes it: 1536 half-units of 2 pages for 1024 slots
OVERCOMMIT_PAGES = 3072
# the attention template's timing variants (csrc/ring_partial.cuh): its
# copies alone and its arithmetic alone, built from the sources below
SPLIT_VARIANTS = {"kernel": (), "copies": ("RING_PARTIAL_SPLIT=1",),
                  "arithmetic": ("RING_PARTIAL_SPLIT=2",)}
SPLIT_SOURCES = ("paged_attention.cu", "paged_attention_grouped.cu")
# device cycles a device_ev_ms call waits before each timed call (~0.5 ms)
SLEEP_CYCLES = 1_000_000
# the stream path: its ring of prompt rows and its submission waves
STREAM_CAPACITY = 1024
STREAM_WAVE = 256
# the sampled main path's engine options, and the sampling kernel's checks:
# (temperature, top_k) at each width; GPT-2's vocabulary
SAMPLE_KW = dict(temperature=1.5, top_k=16, sample_seed=7)
SAMPLE_SETTINGS = ((0.7, 0), (0.7, 16), (1.5, 0), (1.5, 16))
GPT2_VOCAB = 50257
# 32-bit operations of the sampling kernel, integer and float apart. For
# each element it draws: threefry2x32 (2 initial adds, 20 rounds of add,
# rotate and xor, 5 key injections of 2 adds, the final xor: 73), the
# 64-bit counter (2) and the uniform's shift and or (2), integer; the
# uniform's subtract, fma and max, the Gumbel's 2 logf (one operation each)
# and 2 negations, and the argmax's add and compare, float. For each
# element of a live row: the divide by the temperature (float) and, under
# top-k, its select key (the +0 fold, float; sign test and flip, integer),
# the running maximum and the threshold compare (integer)
SAMPLE_DRAW_INT_OPS = 73 + 2 + 2
SAMPLE_DRAW_F32_OPS = 3 + 2 + 2 + 2
SAMPLE_ROW_F32_OPS = 1
SAMPLE_TOPK_INT_OPS = 2 + 1 + 1
SAMPLE_TOPK_F32_OPS = 1
# int32 lanes of an SM on Hopper (a quarter of the 128 float32 lanes that
# F32_FLOPS counts at two operations an FMA); the card's int32 rate is
# INT32_LANES x SMs x the max SM clock (nvidia-smi), set in main()
INT32_LANES = 64
INT32_OPS_PER_S = None
# the sampling kernel's narrow/wide sweep: widths, top_k values
SWITCH_WIDTHS = (1024, 1536, 2048)
SWITCH_TOP_K = (16, 50)
# the mesh stage: [mesh-tp]'s request count (a cut of depth: the gpt2s
# path serves 2048), and the near-tie rule of a request that differs
# there: its first differing token's top-2 gap in a plain float32 forward
# below NEAR_TIE x the largest logit change that int8 KV pages make at
# that position, and at most MESH_TP_MAX_DIFFERING such requests (sound
# runs and a planted fault of the page-scale max: PERF.md, PR 10)
MESH_TP_REQUESTS = 256
NEAR_TIE = 1.0
MESH_TP_MAX_DIFFERING = 8
# the [bench] phase: bench.py's five workloads, README.md's bf16 host
# command line and the host engine on gpt2s (a bf16 model of twelve
# layers: its prefill through the prefill attention kernel, lengths a
# column of the uploaded block) through ``python -m
# min_llm_inference_tpu_torch.bench``, each beside the label of this
# script's own path for that configuration in PATH_WALLS (None: the script
# has none; its flat path is ``attn_flat``, for which bench.py has no flag)
BENCH_WORKLOADS = (
    ((), "main"),
    (("--model", "gpt2s"), "gpt2s"),
    (("--engine", "host", "--attention", "pallas"), "host"),
    (("--ring",), None),
    (("--overcommit", "--pages", "3072", "--warm-requests", "2048"),
     "overcommit"),
    (("--engine", "host", "--kv-dtype", "bfloat16", "--rounds", "32"),
     "bf16-kv-host-grouped"),
    (("--engine", "host", "--model", "gpt2s"), None),
)
BENCH_REPEATS = 3
# the serving bench's open-loop arrival rate (requests/s)
SERVING_RATE = 1000
# the [quality] phase: the quality tool's training steps (its default),
# and the eval steps whose K/V rows of the trained model's last layer the
# fused-write kernel writes beside the plain quantizer: a page's row 0
# (it sets the page's scale) and a row inside the page
QUALITY_STEPS = 1500
QUALITY_KV_STEPS = (96, 103)


T0 = time.perf_counter()


def log(phase: str, **kv) -> None:
    """One line per step, with the seconds since the script started."""
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items())
          + f" t={time.perf_counter() - T0:.1f}s", flush=True)


def device_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms: the durations of the CUDA kernels
    that torch.profiler records over ``iters`` calls, after a warm-up. Host
    dispatch between the calls does not count, as it does in time_ms when
    a wrapper's Python work outlasts its kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(6):           # a trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
    raise AssertionError("the profiler recorded no device time")


def device_ev_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms by CUDA events around each call, each
    call queued behind a device sleep (SLEEP_CYCLES) that outlasts the
    host's dispatch of it: the events time the kernel alone, with no
    profiler in the process."""
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


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


def bf16_pool(rng, dev, shape):
    """A standard-normal bfloat16 pool drawn on the card (a generator
    seeded from ``rng``): the reference path's 1.07 GB pool would take
    seconds to draw with numpy."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


def grouped_case(rng, dev, B, W, P, D, H, kv, in_dtype, NP=None,
                 lengths=None):
    """Random fused-write inputs in the engine's layout: contiguous page
    groups, q/k_new/v_new as column slices of one fused [B, 3D] projection,
    scales already updated for fresh pages, lengths covering dead slots, 1,
    P-1, P, P+1, fresh-page inserts and the last position (or the given
    ``lengths``)."""
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
    if lengths is None:
        lengths = rng.integers(1, W * P + 1, B).astype(np.int32)
        lengths[rng.random(B) < 0.1] = 0
        special = [s for s in (0, 1, P - 1, P, P + 1, 2 * P + 1, W * P, 0,
                               (W - 1) * P + 1) if s <= W * P][:B]
        lengths[: len(special)] = special
    lengths = np.asarray(lengths, np.int32)
    if kv == "int4":
        hi = rng.integers(-7, 8, (NP, 2, P, Dk))
        lo = rng.integers(-7, 8, (NP, 2, P, Dk))
        pool = (16 * hi + lo).astype(np.int8)
    elif kv == "int8":
        pool = rng.integers(-127, 128, (NP, 2, P, Dk)).astype(np.int8)
    elif kv == "float32":
        pool = rng.standard_normal((NP, 2, P, Dk)).astype(np.float32)
    qkv = torch.from_numpy(
        rng.standard_normal((B, 3 * D)).astype(np.float32)).to(dev, in_dtype)
    t = {"q": qkv[:, :D], "k_new": qkv[:, D:2 * D], "v_new": qkv[:, 2 * D:],
         "kw": dict(n_heads=H, packed_int4=packed)}
    t["pool"] = (bf16_pool(rng, dev, (NP, 2, P, Dk)) if kv == "bfloat16"
                 else torch.from_numpy(pool).to(dev))
    t["lengths"] = torch.from_numpy(lengths).to(dev)
    t["table"] = torch.from_numpy(table).to(dev)
    if kv in ("float32", "bfloat16"):
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


def bound_of(nbytes, ops, ops_per_s=F32_FLOPS) -> tuple:
    """The least time in ms for ``nbytes`` of HBM traffic and ``ops``
    operations at ``ops_per_s`` (float32 outside the tensor cores unless
    given), and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# (case, result, kernel call) of every timed check, for device_times()
DEVICE_PENDING = []
# (run, its unprofiled wall, path) of every path to profile once all paths
# have run (``--profile``): a graph with IF nodes captured after a
# torch.profiler session faults with an illegal address when replayed
# under a later one (tools/graph_profile_repro.py), and the profiler's
# host cost stays out of every path's wall
PROFILE_PENDING = []
# the timed run's wall of each full-width path, by label, for [bench]
PATH_WALLS = {}


def timed_pair(name, res, kernel_fn, plain_fn, bound,
               kernel_iters=20) -> None:
    """ms and plain_ms: CUDA events around back-to-back calls of the kernel
    and of its plain version. The kernel's device time alone (device_ms) is
    taken by device_times() once every path has run."""
    res["ms"] = time_ms(kernel_fn, kernel_iters)
    res["plain_ms"] = time_ms(plain_fn, 5, warmup=1)
    res["bound_ms"], res["bound_by"] = bound
    DEVICE_PENDING.append((name, res, kernel_fn))


def device_times(iters: int = 20) -> None:
    """device_ev_ms, then device_ms, of every timed check, one
    [kernel_device] line each. Taken last: once torch.profiler has traced
    the card, every later kernel launch in the process costs more host
    time, which would slow the paths' walls."""
    for _, res, fn in DEVICE_PENDING:
        res["device_ev_ms"] = device_ev_ms(fn, iters)
    for name, res, fn in DEVICE_PENDING:
        res["device_ms"] = device_ms(fn, iters)
        log("kernel_device", case=name, device_ms=f"{res['device_ms']:.6g}",
            device_ev_ms=f"{res['device_ev_ms']:.6g}")
    DEVICE_PENDING.clear()


def log_result(name, check, res) -> None:
    """The [kernel] line of one check: what held and the numbers."""
    log("kernel", case=name, **check, **{
        k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in res.items()
        if not isinstance(v, dict)})


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
    return bound_of(nbytes, 4 * rows * D)       # q.K and p.V multiply-adds


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
        timed_pair(name, res, lambda: kernel(t["q"], pool_k, *args, **kw),
                   lambda: plain(t["q"], pool_p, *args, **kw),
                   grouped_bound_ms(t))
        lens = t["lengths"].cpu().numpy()
        res["live_slots"] = int((lens > 0).sum())
        res["mean_live_len"] = float(lens[lens > 0].mean())
    log_result(name, {"pool_bytes": "identical"}, res)
    return res


def partial_case(rng, dev, B, W, P, D, kv, in_dtype, NP):
    """Random ring-partial inputs in the engine's layout: full-grant page
    groups, q a column slice of one fused [B, 3D] projection, ring_start
    covering 0 (a live slot whose context is all in the ring), page
    boundaries and the full width, ~10% dead slots."""
    NG = NP // W
    packed = kv == "int4"
    Dk = D // 2 if packed else D
    gids = rng.permutation(NG)[:B]
    table = (gids[:, None] * W + np.arange(W)[None, :]).astype(np.int32)
    rs = rng.integers(0, W * P, B).astype(np.int32)
    rs[:6] = [0, 1, P - 1, P, P + 1, W * P - 1]
    lengths = np.minimum(rs + rng.integers(1, 17, B), W * P).astype(np.int32)
    lengths[6:][rng.random(B - 6) < 0.1] = 0
    shape = (NP, 2, P, Dk)
    if packed:
        pool = (16 * rng.integers(-7, 8, shape, dtype=np.int8)
                + rng.integers(-7, 8, shape, dtype=np.int8))
    elif kv == "int8":
        pool = rng.integers(-127, 128, shape, dtype=np.int8)
    elif kv == "float32":
        pool = rng.standard_normal(shape, dtype=np.float32)
    qkv = torch.from_numpy(
        rng.standard_normal((B, 3 * D)).astype(np.float32)).to(dev, in_dtype)
    t = {"q": qkv[:, :D],
         "pool": (bf16_pool(rng, dev, shape) if kv == "bfloat16"
                  else torch.from_numpy(pool).to(dev)),
         "rs": torch.from_numpy(rs).to(dev),
         "lengths": torch.from_numpy(lengths).to(dev),
         "table": torch.from_numpy(table).to(dev), "ks": None, "vs": None,
         "packed": packed}
    if kv in ("int8", "int4"):
        for side in ("ks", "vs"):
            t[side] = torch.from_numpy(
                (rng.random(NP) * 0.05 + 0.001).astype(np.float32)).to(dev)
    return t


def half_group_case(rng, dev, B, W, P, D, kv, in_dtype, NP):
    """partial_case on overcommit's page table: every row two independent
    half-groups of W/2 pages, a row whose context fits its first half
    repeating that half ("ungrown"); slot 7 dead with a stale ring_start
    of 5."""
    t = partial_case(rng, dev, B, W, P, D, kv, in_dtype, NP)
    Hp = W // 2
    rs = t["rs"].cpu().numpy()
    units = rng.permutation(NP // Hp)
    table = np.zeros((B, W), np.int32)
    for b in range(B):
        first = units[2 * b] * Hp + np.arange(Hp)
        grown = rs[b] + 4 > Hp * P
        second = units[2 * b + 1] * Hp + np.arange(Hp) if grown else first
        table[b] = np.concatenate([first, second])
    t["table"] = torch.from_numpy(table).to(dev)
    t["lengths"][7] = 0
    t["rs"][7] = 5
    return t


def partial_bound(t, H, per_page_table=False) -> tuple:
    """Least time of one ring-partial call on inputs ``t``: q of the live
    slots, the K and V rows below each live slot's ring_start, the scales
    of the pages they sit in, o/m/l written, lengths, ring_start and one
    table entry per slot (``per_page_table``: per page read) read; 4 f32
    operations per context row per feature."""
    B, D = t["q"].shape
    _, _, P, Dk = t["pool"].shape
    W = t["table"].shape[1]
    lens = t["lengths"].cpu().numpy()
    rs = np.clip(t["rs"].cpu().numpy()[lens > 0], 0, W * P).astype(np.int64)
    pages = int(np.ceil(rs / P).sum())
    nbytes = ((lens > 0).sum() * D * t["q"].element_size()
              + int(rs.sum()) * 2 * Dk * t["pool"].element_size()
              + (2 * pages * 4 if t["ks"] is not None else 0)
              + B * (D + 2 * H) * 4 + 2 * B * 4
              + (pages if per_page_table else B) * 4)
    return bound_of(nbytes, 4 * int(rs.sum()) * D)


def check_partial(name, kind, t, H, timed, tol=1e-4):
    """Ring-partial kernel (``kind``: "grouped" mode c, "dgrid" or "flat")
    vs its plain version on the inputs ``t``: o, m and l within
    tol * max(1, |x|max) (float32 sums in another order); rows without
    context (dead, ring_start == 0) exactly o = 0, m = -inf, l = 0; the
    pool unchanged."""
    from min_llm_inference_tpu_torch.ops import paged_attention_dgrid as dg
    from min_llm_inference_tpu_torch.ops import paged_attention_flat as fl
    from min_llm_inference_tpu_torch.ops import paged_attention_grouped as gr

    P = t["pool"].shape[2]
    if kind == "grouped":
        args = (t["q"], t["pool"], t["lengths"], t["table"], t["ks"],
                t["vs"])
        kw = dict(ring_start=t["rs"], n_heads=H, packed_int4=t["packed"])
        kernel = gr.paged_decode_attention_grouped
        plain = gr.paged_decode_attention_grouped_plain
    elif kind == "flat":
        args = (t["q"], t["pool"], t["lengths"], t["table"], t["ks"],
                t["vs"], t["rs"])
        kw = dict(n_heads=H, packed_int4=t["packed"])
        kernel = fl.paged_decode_attention_flat
        plain = fl.paged_decode_attention_flat_plain
    else:
        args = (t["q"], t["pool"], t["ks"], t["vs"], t["rs"], t["lengths"],
                t["table"])
        kw = dict(n_heads=H, page_size=P)
        kernel, plain = dg.dgrid_paged_partial, dg.dgrid_paged_partial_plain
    pool0 = t["pool"].clone()
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(pool0, t["pool"]):
        raise AssertionError(f"{name}: the pool changed")
    empty = (t["lengths"] == 0) | (t["rs"] == 0)
    o, m, l = got
    if not (torch.all(o[empty] == 0) and torch.all(l[empty] == 0)
            and torch.all(torch.isneginf(m[empty]))):
        raise AssertionError(f"{name}: empty rows are not o=0, m=-inf, l=0")
    err = 0.0
    for label, g, w in zip("oml", got, want):
        if not bool((~empty).any()):
            break
        e = (g[~empty] - w[~empty]).abs().max().item()
        lim = tol * max(1.0, w[~empty].abs().max().item())
        if not e <= lim:
            raise AssertionError(f"{name}: max |{label}_kernel - "
                                 f"{label}_plain| {e} > {lim}")
        err = max(err, e)
    res = {"max_abs_err": err}
    if timed:
        timed_pair(name, res, lambda: kernel(*args, **kw),
                   lambda: plain(*args, **kw),
                   partial_bound(t, H, per_page_table=kind == "flat"))
        lens = t["lengths"].cpu().numpy()
        rs = t["rs"].cpu().numpy()[lens > 0]
        res["live_slots"] = int((lens > 0).sum())
        res["mean_live_ring_start"] = float(rs.mean())
    log_result(name, {"o_m_l": "close"}, res)
    return res


def partial_edges(rng, dev, errs) -> None:
    """The two ring-partial kernels (dgrid, flat) at their edges, each held
    by check_partial: 12-head int8 contexts too long for a kernel that
    keeps a whole context's scores in shared memory (flat W*P = 1024, int8
    and packed int4;
    dgrid W*P = 8192), with a live slot at ring_start = W*P; the drained
    batch of 512 slots at the gpt2s shapes; 61 slots; every slot dead with
    a stale ring_start; flat on fragmented tables whose dead rows hold live
    slots' pages, and on half-group tables at W = 32."""
    g = GPT2S
    D, H, P = g["emb_dim"], g["n_heads"], g["page_size"]

    def full_width(t, W):
        t["rs"][6] = W * P
        t["lengths"][6] = W * P
        return t

    # (kind, label, inputs); every case has 12 heads but the 61-slot one
    cases = [("dgrid", "long-W256-int8", full_width(partial_case(
        rng, dev, 24, 256, P, D, "int8", torch.bfloat16, 26 * 256), 256))]
    for kv in ("int8", "int4"):
        cases.append(("flat", f"long-W32-{kv}", full_width(partial_case(
            rng, dev, 40, 32, P, D, kv, torch.bfloat16, 42 * 32), 32)))
    cases.append(("flat", "half-W32-int8", half_group_case(
        rng, dev, 40, 32, P, D, "int8", torch.bfloat16, 42 * 32)))
    for kind in ("dgrid", "flat"):
        cases.append((kind, "drained-B512-int8", partial_case(
            rng, dev, 512, 4, P, D, "int8", torch.bfloat16, g["n_pages"])))
        cases.append((kind, "B61-H2-f32", partial_case(
            rng, dev, 61, 4, 16, 96, "float32", torch.float32, 63 * 4)))
        dead = partial_case(rng, dev, 16, 4, 8, 96, "int8", torch.float32,
                            18 * 4)
        dead["lengths"].zero_()
        cases.append((kind, "all-dead", dead))
    for kv in ("float32", "int8", "int4"):
        t = partial_case(rng, dev, 40, 8, 16, 96, kv, torch.bfloat16, 42 * 8)
        table = rng.permutation(42 * 8)[:40 * 8].reshape(40, 8)
        lens = t["lengths"].cpu().numpy()
        live = np.nonzero(lens > 0)[0]
        for d in np.nonzero(lens == 0)[0]:
            table[d] = table[rng.choice(live)]
        t["table"] = torch.from_numpy(table.astype(np.int32)).to(dev)
        cases.append(("flat", f"fragmented-{kv}", t))
    for kind, label, t in cases:
        r = check_partial(f"{kind}-{label}", kind, t,
                          2 if label.startswith("B61") else H, timed=False)
        errs["dgrid_paged_partial" if kind == "dgrid"
             else "paged_decode_attention_flat"].append(r["max_abs_err"])


def attention_edges(rng, dev, errs) -> None:
    """The one-slot and the grouped kernel (modes a and b by check_grouped,
    c by check_partial) at their edges, each held against its plain
    version: 12-head contexts of W*P = 4096 at emb 768 (int8; int4 for the
    grouped modes), which the kernels that kept a whole context's scores in
    shared memory refused, with a slot at the full width; rows of 8192
    features in one head at W*P = 128 (two feature slices in a cluster);
    the fused write at one head of 2048 features with the new row at every
    position class of a tile and a page, the last tile among the ring's
    first stages and past them, five times over one pool."""
    P = 32
    one = errs["paged_decode_attention"]
    grouped = errs["paged_decode_attention_grouped"]
    for label, B, W, D, H in (("long-W128", 24, 128, 768, 12),
                              ("wide-D8192", 32, 4, 8192, 1)):
        t = one_slot_case(rng, dev, B, W, P, D, "int8", torch.bfloat16,
                          B * W + 3)
        one.append(check_one_slot(f"one-slot-{label}-int8", t, H,
                                  timed=False)["max_abs_err"])
        for kv in ("int8", "int4"):
            t = grouped_case(rng, dev, B, W, P, D, H, kv, torch.bfloat16,
                             NP=(B + 3) * W)
            grouped.append(check_grouped(f"grouped-{label}-{kv}", t,
                                         timed=False)["max_abs_err"])
            t = partial_case(rng, dev, B, W, P, D, kv, torch.bfloat16,
                             (B + 2) * W)
            t["rs"][6] = W * P
            t["lengths"][6] = W * P
            grouped.append(check_partial(f"grouped-c-{label}-{kv}",
                                         "grouped", t, H,
                                         timed=False)["max_abs_err"])
    lengths = [0, 1, 4, 8, 9, 12, 16, 17, 20, 24, 25, 31, 32, 33, 36, 40, 47,
               48, 49, 64, 65, 72, 96, 97, 100, 112, 127, 128, 0, 3]
    for kv in ("int8", "int4"):
        t = grouped_case(rng, dev, len(lengths), 4, P, MAIN["emb_dim"], 1,
                         kv, torch.bfloat16, NP=(len(lengths) + 3) * 4,
                         lengths=lengths)
        for rep in range(5):
            grouped.append(check_grouped(f"fused-positions-{kv}-{rep}", t,
                                         timed=False)["max_abs_err"])


def split_times(rng, dev, rounds: int = 3) -> dict:
    """Copies against in-block arithmetic at one head of 2048 features:
    device_ev_ms of the kernel and of its timing variants (SPLIT_VARIANTS:
    the same source built to only copy, or only compute), in turns,
    ``rounds`` times, on random inputs at the main paths' shapes: the
    one-slot kernel at the host path's (int8) and the fused write at the
    reference path's (packed int4) and with int8 pages (as overcommit's).
    One [split] line per shape; returns {shape: {variant: [ms, ...]}}."""
    from min_llm_inference_tpu_torch.ops import paged_attention as pa
    from min_llm_inference_tpu_torch.ops import paged_attention_grouped as gr

    P, B, D = MAIN["page_size"], MAIN["n_slots"], MAIN["emb_dim"]
    W = -(-MAIN["n_seq"] // P)
    t = one_slot_case(rng, dev, B, W, P, D, "int8", torch.bfloat16,
                      MAIN["n_pages"])
    calls = {"one-slot-int8": lambda defs, t=t: pa._launch(
        t["q"], t["pool"], t["lengths"], t["table"], t["ks"], t["vs"], 1,
        defs)}
    for kv in ("int4", "int8"):
        t = grouped_case(rng, dev, B, W, P, D, 1, kv, torch.bfloat16,
                         NP=MAIN["n_pages"])
        calls[f"fused-{kv}"] = lambda defs, t=t, packed=kv == "int4": (
            gr._launch(t["q"], t["pool"], t["lengths"], t["table"], t["ks"],
                       t["vs"], t["k_new"], t["v_new"], None, 1, packed,
                       defs))
    out = {shape: {v: [] for v in SPLIT_VARIANTS} for shape in calls}
    for _ in range(rounds):
        for shape, call in calls.items():
            for v, defs in SPLIT_VARIANTS.items():
                out[shape][v].append(
                    device_ev_ms(lambda call=call, defs=defs: call(defs)))
    for shape, times in out.items():
        log("split", shape=shape, **{
            f"{v}_ms": "/".join(f"{x:.6g}" for x in ms)
            for v, ms in times.items()})
    return out


def flush_case(rng, dev, B, W, P, Dk, NP, n_rounds, dtype=torch.int8):
    """Random flush inputs as the gpt2s burst leaves them: full-grant page
    groups, ring_start = burst-start length - 1, up to n_rounds rows per
    slot (fewer where a request finished), ~10% dead slots, no ring_r0."""
    NG = NP // W
    gids = rng.permutation(NG)[:B]
    table = (gids[:, None] * W + np.arange(W)[None, :]).astype(np.int32)
    rs = rng.integers(0, W * P - n_rounds, B).astype(np.int32)
    lengths = (rs + rng.integers(1, n_rounds + 1, B)).astype(np.int32)
    lengths[rng.random(B) < 0.1] = 0
    R = max(8, -(-n_rounds // 8) * 8)
    if dtype == torch.int8:
        pool = torch.from_numpy(rng.integers(-127, 128, (NP, 2, P, Dk),
                                             dtype=np.int8))
        ring = torch.from_numpy(rng.integers(-127, 128, (B, R, 2 * Dk),
                                             dtype=np.int8))
    else:
        pool = torch.from_numpy(rng.standard_normal((NP, 2, P, Dk))).to(dtype)
        ring = torch.from_numpy(rng.standard_normal((B, R, 2 * Dk))).to(dtype)
    return {"pool": pool.to(dev), "ring": ring.to(dev),
            "rs": torch.from_numpy(rs).to(dev),
            "lengths": torch.from_numpy(lengths).to(dev),
            "table": torch.from_numpy(table).to(dev),
            "n_rounds": n_rounds, "r0": None}


def flush_rows(t) -> tuple:
    """(valid ring rows, touched pages) of one flush on inputs ``t``."""
    B = t["ring"].shape[0]
    P = t["pool"].shape[2]
    lens = t["lengths"].cpu().numpy().astype(np.int64)
    rs = t["rs"].cpu().numpy().astype(np.int64)
    r0 = (np.zeros(B, np.int64) if t["r0"] is None
          else t["r0"].cpu().numpy().astype(np.int64))
    nv = np.where(lens > 0, np.minimum(lens - rs, t["n_rounds"] - r0), 0)
    nv = np.maximum(nv, 0)
    live = nv > 0
    pages = (rs + nv - 1) // P - rs // P + 1
    return int(nv.sum()), int(pages[live].sum())


def flush_bound(t) -> tuple:
    """Least time of one flush: each valid ring row (K and V) read once and
    written once into its page, plus lengths, ring_start (and ring_r0) and
    the touched table entries."""
    B, _, two_dk = t["ring"].shape
    rows, pages = flush_rows(t)
    nbytes = (2 * rows * two_dk * t["ring"].element_size()
              + B * 4 * (3 if t["r0"] is not None else 2) + pages * 4)
    return bound_of(nbytes, 0)


def check_flush(name, t, timed):
    """Ring flush kernel vs its plain version on copies of one pool: pool
    bytes bit-identical."""
    from min_llm_inference_tpu_torch.ops.ring_flush import (
        ring_flush as kernel,
        ring_flush_plain as plain,
    )

    args = (t["ring"], t["rs"], t["lengths"], t["table"])
    kw = dict(n_rounds=t["n_rounds"], ring_r0=t["r0"])
    pool_k, pool_p = t["pool"].clone(), t["pool"].clone()
    kernel(pool_k, *args, **kw)
    plain(pool_p, *args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(pool_k.view(torch.uint8), pool_p.view(torch.uint8)):
        raise AssertionError(f"{name}: pool bytes differ")
    if torch.equal(pool_k, t["pool"]) and bool((t["lengths"] > 0).any()):
        raise AssertionError(f"{name}: nothing was written")
    res = {"max_abs_err": 0.0}
    if timed:
        timed_pair(name, res, lambda: kernel(pool_k, *args, **kw),
                   lambda: plain(pool_p, *args, **kw), flush_bound(t))
        res["valid_rows"], res["touched_pages"] = flush_rows(t)
    log_result(name, {"pool_bytes": "identical"}, res)
    return res


def prefill_case(rng, dev, M, S_pre, D, P, W, NP, in_dtype=torch.bfloat16):
    """Random prefill-scatter inputs as a gpt2s prefill bucket hands them
    over: K and V column slices of one fused [M, S_pre, 2D] projection,
    pages of full-grant groups, prompts uniform in [1, S_pre] (pages past
    the prompt pid = NP), inverse scales of updated page scales."""
    W_pre = S_pre // P
    gids = rng.permutation(NP // W)[:M]
    pages = (gids[:, None] * W + np.arange(W_pre)[None, :]).astype(np.int32)
    plens = rng.integers(1, S_pre + 1, M)
    covered = np.arange(W_pre)[None, :] * P < plens[:, None]
    pid = np.where(covered, pages, NP).astype(np.int32)
    s = (rng.random((2, M, W_pre)) * 0.05 + 0.001).astype(np.float32)
    inv = np.float32(1) / s
    kv = torch.from_numpy(
        rng.standard_normal((M, S_pre, 2 * D)).astype(np.float32)).to(
            dev, in_dtype)
    return {"pool": torch.from_numpy(rng.integers(-127, 128, (NP, 2, P, D),
                                                  dtype=np.int8)).to(dev),
            "k": kv[..., :D], "v": kv[..., D:],
            "pid": torch.from_numpy(pid).to(dev),
            "inv_k": torch.from_numpy(inv[0]).to(dev),
            "inv_v": torch.from_numpy(inv[1]).to(dev)}


def prefill_bound(t) -> tuple:
    """Least time of one prefill scatter: the covered pages' K and V rows
    read once and written once as int8, plus pid and the inverse scales."""
    M, S_pre, D = t["k"].shape
    NP, _, P, _ = t["pool"].shape
    covered = int((t["pid"] < NP).sum().item())
    nbytes = (covered * 2 * P * D * (t["k"].element_size() + 1)
              + t["pid"].numel() * 12)
    return bound_of(nbytes, 0)


def check_prefill(name, t, timed):
    """Prefill scatter kernel vs its plain version on copies of one pool:
    pool bytes bit-identical."""
    from min_llm_inference_tpu_torch.ops.prefill_scatter import (
        prefill_quant_scatter as kernel,
        prefill_quant_scatter_plain as plain,
    )

    args = (t["k"], t["v"], t["pid"], t["inv_k"], t["inv_v"])
    pool_k, pool_p = t["pool"].clone(), t["pool"].clone()
    kernel(pool_k, *args)
    plain(pool_p, *args)
    torch.cuda.synchronize()
    if not torch.equal(pool_k, pool_p):
        bad = (pool_k != pool_p).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: pool bytes differ at {bad}")
    res = {"max_abs_err": 0.0}
    if timed:
        timed_pair(name, res, lambda: kernel(pool_k, *args),
                   lambda: plain(pool_p, *args), prefill_bound(t))
        res["covered_pages"] = int((t["pid"] < t["pool"].shape[0]).sum())
    log_result(name, {"pool_bytes": "identical"}, res)
    return res


# the causal prefill attention's cases: the long-prompt cell's busiest
# block (64 prompts of 512-896 tokens padded to 1024; timed), the
# reasoning cell's (16-128 padded to 128; timed), the tile edges, and every
# head dim at a row count that is no tile multiple
PREFILL_ATTN_CASES = (
    ("long-prompt", 64, 1024, 12, 64, (512, 896), (), True),
    ("reasoning", 64, 128, 12, 64, (16, 128), (), True),
    ("edges", 8, 1024, 12, 64, (512, 896),
     (0, 1, 31, 32, 33, 512, 896, 1024), False),
    *((f"dh{dh}", 4, 100, 2, dh, (1, 100), (100, 65, 33, 0), False)
      for dh in range(16, 129, 16)),
)
BF16_TENSOR_FLOPS = 989e12


def prefill_attn_bound(lens, S, H, dh) -> tuple:
    """Least time in ms of one causal prefill attention over prompts of
    ``lens`` padded to S: q, k and v rows below each length read once, the
    whole [M, S, D] output written once, or the tensor-core operations
    the function needs (q . k and P . V once each over the causal pairs,
    2 + 2 operations a pair and feature; the kernel's three bf16 terms of
    P are its own choice) at the bf16 peak. Returns (ms, by, bytes_ms,
    ops_ms)."""
    D = H * dh
    nbytes = 3 * sum(lens) * D * 2 + len(lens) * S * D * 2 + len(lens) * 4
    pairs = H * sum(n * (n + 1) // 2 for n in lens)
    ms, by = bound_of(nbytes, 4 * pairs * dh, BF16_TENSOR_FLOPS)
    return (ms, by, nbytes / HBM_BYTES_PER_S * 1e3,
            4 * pairs * dh / BF16_TENSOR_FLOPS * 1e3)


def check_prefill_attn(dev, seed, name, M, S, H, dh, span, edges, timed):
    """The prefill attention kernel against its plain version on one case
    (tests/test_torch_prefill_attention.py's checks): float32 output within
    2e-5 of each (row, head)'s scale, bfloat16 output within one bf16 ulp
    (floored at 1/256 of that scale), zeros on rows at or past the length;
    two launches counted. Timed: the kernel (events around one call behind
    a device sleep, and back to back), the plain version, the bound, and
    scaled_dot_product_attention (is_causal, no length mask, bf16 P) on the
    same inputs as a yardstick only."""
    from min_llm_inference_tpu_torch.models.model import (
        causal_masked_attention as plain,
    )
    from min_llm_inference_tpu_torch.ops import prefill_attention as pa

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    D = H * dh
    q = torch.randn((M, S, D), generator=gen, device=dev).to(torch.bfloat16)
    kv = torch.randn((M, S, 2 * D), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = kv[..., :D], kv[..., D:]
    lens = rng.integers(span[0], span[1] + 1, M)
    lens[:len(edges)] = edges
    lengths = torch.from_numpy(lens.astype(np.int32)).to(dev)
    before = pa.prefill_causal_attention.launches
    got32 = pa.prefill_causal_attention(
        q, k, v, lengths, H, out=torch.empty((M, S, D), device=dev))
    got16 = pa.prefill_causal_attention(q, k, v, lengths, H)
    want32 = plain(q.float(), k.float(), v.float(), lengths, H)
    torch.cuda.synchronize()
    launches = pa.prefill_causal_attention.launches - before
    valid = torch.arange(S, device=dev)[None, :] < lengths[:, None].long()
    if launches != 2 or not all(torch.all(g[~valid] == 0)
                                for g in (got32, got16)):
        raise AssertionError(f"prefill-attn {name}: {launches} launches, or "
                             "rows past the length not zero")
    heads = (M, S, H, dh)
    want = want32.reshape(heads)[valid]
    scale = want.abs().amax(dim=-1, keepdim=True)
    rel = ((got32.reshape(heads)[valid] - want).abs() / scale).max().item()
    w16 = want.to(torch.bfloat16).float()
    _, exp = torch.frexp(torch.maximum(w16.abs(), scale / 256))
    ulps = ((got16.reshape(heads)[valid].float() - w16).abs()
            / torch.ldexp(torch.ones_like(w16), exp - 8)).max().item()
    if not rel <= 2e-5 or not ulps <= 1:
        raise AssertionError(f"prefill-attn {name}: float32 off by {rel:.3g} "
                             f"of its scale, bfloat16 by {ulps} ulp")
    res = {"max_rel_err": rel, "bf16_max_ulps": ulps,
           "valid_rows": int(valid.sum())}
    del want32, want, w16, got32
    if timed:
        kernel = lambda: pa.prefill_causal_attention(q, k, v, lengths, H)
        bound = prefill_attn_bound(lens.tolist(), S, H, dh)
        timed_pair(f"prefill-attn-{name}", res, kernel,
                   lambda: plain(q, k, v, lengths, H), bound[:2])
        res["device_ev_ms"] = device_ev_ms(kernel)
        res["bound_bytes_ms"], res["bound_ops_ms"] = bound[2:]
        q4, k4, v4 = (t.view(M, S, H, dh).transpose(1, 2) for t in (q, k, v))
        res["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True), 20)
    log("prefill-attn", case=name, M=M, S=S, H=H, dh=dh,
        lengths=f"{int(lens.min())}-{int(lens.max())}", launches=launches,
        f32="close", bf16="within-1-ulp", past_length="zero",
        **{k_: (f"{x:.6g}" if isinstance(x, float) else x)
           for k_, x in res.items()})
    torch.cuda.empty_cache()
    return res


def prefill_attn_phase(dev) -> dict:
    """[prefill-attn]: every case of PREFILL_ATTN_CASES. Returns the
    results by case name."""
    return {c[0]: check_prefill_attn(dev, 17 + i, *c)
            for i, c in enumerate(PREFILL_ATTN_CASES)}


# DeepSeek-V2-Lite's widths and the deepseek-v2-lite.long-context cell's
# decode round: 256 slots of contexts 3584-4096 over 128 pages of 32
DSV2 = dict(B=256, W=128, P=32, heads=16, latent=512, rope=64, scale=0.114721,
            E=64, D=2048, Fm=1408, k=6)


def rel_err(got, want) -> float:
    """Largest error over each row's largest magnitude."""
    scale = want.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return float(((got.float() - want.float()).abs() / scale).max())


def deepseek_kernels(dev) -> dict:
    """[deepseek] kernel lines, returned by check (``mla``, ``prefill``,
    ``moe-decode``, ``moe-prefill``) as kernel_entry reads them: the
    absorbed latent decode kernel at the cell's round (256 slots, lengths
    3584-4096, 8 dead slots with stale table rows) against its plain
    version, within 2^-7 of each head's scale, dead rows zero; the prefill kernel at 192 / 128 on two of the
    cell's 4096-row prompts against the plain float32 attention (5e-5 of
    each row's scale), timed on the cell's 16-prompt block; the grouped
    SwiGLU of a decode round's 1536 rows against a per-expert loop (2^-6),
    timed there and on a prefill block's 393,216 rows. Each timed beside
    its bound (bytes at 3.35 TB/s, tensor-core FLOPs at 989 TFLOP/s)."""
    from min_llm_inference_tpu_torch.models import deepseek_v2 as ds
    from min_llm_inference_tpu_torch.ops import mla_decode as md
    from min_llm_inference_tpu_torch.ops import moe
    from min_llm_inference_tpu_torch.ops import prefill_attention as pa

    c = DSV2
    B, W, P, H = c["B"], c["W"], c["P"], c["heads"]
    Dl = c["latent"] + c["rope"]
    rng = np.random.default_rng(19)
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    out = {}
    NP = B * W
    pool = torch.randn((NP, P, Dl), generator=gen, device=dev).to(
        torch.bfloat16)
    q = (torch.randn((B, H, Dl), generator=gen, device=dev) * 0.3).to(
        torch.bfloat16)
    table = torch.from_numpy(rng.permutation(NP).reshape(B, W)
                             .astype(np.int32)).to(dev)
    lens = rng.integers(3584, W * P + 1, B)
    lens[:3] = [W * P, 3584, 3585]
    lens[-8:] = 0
    table[-8:] = table[0]
    lengths = torch.from_numpy(lens.astype(np.int32)).to(dev)
    kernel = lambda: md.mla_decode_attention(q, pool, lengths, table,
                                             c["scale"])
    got = kernel()
    want = md.plain_mla_decode(q, pool, lengths, table, c["scale"],
                               c["latent"])
    live = lengths > 0
    err = rel_err(got[live], want[live])
    if not err <= 2 ** -7 or not torch.all(got[~live] == 0):
        raise AssertionError(f"mla-decode: off by {err:.3g} of the scale, or "
                             "dead rows not zero")
    rows = int(lens.sum())
    n_live = int((lens > 0).sum())
    nbytes = rows * Dl * 2 + n_live * H * (Dl + c["latent"]) * 2
    flops = rows * 2 * H * (Dl + c["latent"])
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS) * 1e3
    ev = device_ev_ms(kernel)
    plain_ms = time_ms(lambda: md.plain_mla_decode(
        q, pool, lengths, table, c["scale"], c["latent"]), 3)
    by = "bytes" if nbytes / HBM_BYTES_PER_S > flops / BF16_TENSOR_FLOPS \
        else "operations"
    out["mla"] = dict(ms=ev, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                      max_abs_err=err)
    log("deepseek", case="mla-decode", B=B, W=W, P=P, live=n_live,
        lengths=f"{int(lens[lens > 0].min())}-{int(lens.max())}",
        max_rel_err=f"{err:.3g}", dead_rows="zero",
        splits=md.splits(B, W, P)[0], device_ev_ms=f"{ev:.5g}",
        plain_ms=f"{plain_ms:.5g}", bound_ms=f"{bound:.5g}", bound_by=by,
        roofline_pct=f"{100 * bound / ev:.4g}")
    del pool, want
    torch.cuda.empty_cache()

    # prefill at 192 / 128: two prompts checked, the 16-prompt block timed
    M, S = 16, 4096
    qp = torch.randn((M, S, H * 192), generator=gen, device=dev).to(
        torch.bfloat16)
    kp = torch.randn((M, S, H * 192), generator=gen, device=dev).to(
        torch.bfloat16)
    kvp = torch.randn((M, S, H * 256), generator=gen, device=dev).to(
        torch.bfloat16)
    vp = kvp[..., H * 128:]
    plens = rng.integers(3584, 3969, M)
    lengths = torch.from_numpy(plens.astype(np.int32)).to(dev)
    want = ds.causal_attention(qp[:2].float(), kp[:2].float(), vp[:2].float(),
                               lengths[:2], H, c["scale"])
    got32 = torch.empty((2, S, H * 128), device=dev)
    pa.prefill_causal_attention(qp[:2], kp[:2], vp[:2], lengths[:2], H,
                                out=got32, scale=c["scale"])
    errs = []
    for m in range(2):
        n = int(plens[m])
        errs.append(rel_err(got32[m, :n].view(n, H, 128),
                            want[m, :n].view(n, H, 128)))
        if not torch.all(got32[m, n:] == 0):
            raise AssertionError("prefill-192: rows past the length")
    # 5e-5: four times the 1024-row cases' 2e-5, the float32 sums over up
    # to 4096 keys taken in another order than the plain version's
    if not max(errs) <= 5e-5:
        raise AssertionError(f"prefill-192: off by {max(errs):.3g}")
    del want, got32
    kernel = lambda: pa.prefill_causal_attention(qp, kp, vp, lengths, H,
                                                 scale=c["scale"])
    # q . k and P . V once each: the kernel's three bf16 terms of P are its
    # own choice, not work the function needs
    pairs = float(sum(n * (n + 1) / 2 for n in plens))
    flops = pairs * H * 2 * (192 + 128)
    nbytes = M * S * H * (192 * 2 + 128 * 2) * 2
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S > flops / BF16_TENSOR_FLOPS \
        else "operations"
    ev = device_ev_ms(kernel, 5)
    out["prefill"] = dict(ms=ev, bound_ms=bound, bound_by=by,
                          max_abs_err=max(errs))
    log("deepseek", case="prefill-192-128", M=M, S=S, H=H,
        lengths=f"{int(plens.min())}-{int(plens.max())}",
        max_rel_err=f"{max(errs):.3g}", past_length="zero",
        device_ev_ms=f"{ev:.5g}", bound_ms=f"{bound:.5g}", bound_by=by,
        roofline_pct=f"{100 * bound / ev:.4g}")
    del qp, kp, kvp
    torch.cuda.empty_cache()

    # the grouped SwiGLU of the experts
    E, D, Fm, k = c["E"], c["D"], c["Fm"], c["k"]
    w_gu = (torch.randn((E, D, 2 * Fm), generator=gen, device=dev)
            * 0.02).to(torch.bfloat16)
    w_dn = (torch.randn((E, Fm, D), generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    for name, n in (("decode", B * k), ("prefill", M * S * k)):
        xs = torch.randn((n, D), generator=gen, device=dev).to(torch.bfloat16)
        ids = np.sort(rng.integers(0, E, n))
        ends = torch.from_numpy(np.searchsorted(ids, np.arange(1, E + 1))
                                .astype(np.int32)).to(dev)
        kernel = lambda: moe.grouped_swiglu(xs, ends, w_gu, w_dn)
        line, res = {}, {}
        if name == "decode":
            got = kernel()
            want = torch.empty_like(got)
            start = 0
            for e, end in enumerate(ends.tolist()):
                want[start:end] = ds.swiglu(xs[start:end], w_gu[e], w_dn[e])
                start = end
            err = rel_err(got, want)
            if not err <= 2 ** -6:
                raise AssertionError(f"grouped-swiglu: off by {err:.3g}")
            line["max_rel_err"] = f"{err:.3g}"
            res["max_abs_err"] = err
        nbytes = (w_gu.numel() + w_dn.numel()) * 2 + n * (2 * D + 3 * Fm) * 2
        flops = n * 6 * D * Fm
        bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S > flops / BF16_TENSOR_FLOPS \
            else "operations"
        ev = device_ev_ms(kernel, 10)
        out[f"moe-{name}"] = dict(ms=ev, bound_ms=bound, bound_by=by, **res)
        log("deepseek", case=f"grouped-swiglu-{name}", rows=n, **line,
            device_ev_ms=f"{ev:.5g}", bound_ms=f"{bound:.5g}", bound_by=by,
            roofline_pct=f"{100 * bound / ev:.4g}")
        del xs
    del w_gu, w_dn
    torch.cuda.empty_cache()
    return out


def deepseek_path(T, dev, gpu_line) -> dict:
    """[deepseek] path: DeepSeek-V2-Lite whole (27 layers, 64 + 2 experts,
    vocab 102400) on AutonomousEngine with the cell's engine (256 slots,
    a full-grant latent pool of 32768 pages, 16 admissions a burst, drain
    to 128): a 32-request warm run under the sync debug mode (its syncs:
    two uploads, one status read a chunk, the final pull; none inside a
    burst, which is captured), then a timed replay of the same queue
    shape, whose launches must be the latent decode kernel's 27 a round,
    the 192 / 128 prefill kernel's 26 a prefill block (the plain attention
    never taken on the card), the grouped SwiGLU's 26 a round and 25 a
    block, and no other counted kernel's. Peak memory and the card beside
    the walls. Returns the timed run's launches by kernel name."""
    from min_llm_inference_tpu_torch.models import deepseek_v2 as ds

    model = T.ModelConfig(arch="deepseek_v2", n_vocab=102400, emb_dim=2048,
                          n_seq=4096, n_layers=27, n_heads=16, ffn_dim=10944,
                          dtype="bfloat16", eof_token_id=100001)
    cfg = T.EngineConfig(n_slots=256, n_forward_rounds=16, page_size=32,
                         n_pages=32768, kv_dtype="bfloat16",
                         max_prefill_batch=16, decode_ring=False)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = ds.init_params(model, 0, dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    eng = T.AutonomousEngine(params, model, cfg, device=dev,
                             max_new_per_burst=16,
                             bursts_per_chunk=6, request_capacity=256,
                             min_drain_slots=128)
    rng = np.random.default_rng(5)

    plens = {}

    def store(n):
        st = T.ItemStorage()
        for i in range(n):
            plens[i] = int(rng.integers(3584, 3969))
            st.add_new_item(T.Request(i, rng.integers(
                0, 100001, plens[i]).tolist()))
        return st

    def run(n, count_syncs):
        eng.stats = T.BurstStats()
        st = store(n)
        torch.cuda.synchronize()
        t = time.perf_counter()
        seen = []
        if count_syncs:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    eng.run(st)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        else:
            eng.run(st)
        torch.cuda.synchronize()
        pkg = os.path.dirname(T.__file__)
        n_seen = sum(1 for w in seen if "synchroniz" in str(w.message)
                     and w.filename.startswith(pkg))
        return st, time.perf_counter() - t, n_seen

    st, wall, n_seen = run(32, True)
    s = eng.stats
    want = 2 + -(-s.bursts // eng.chunk) + 1
    log("syncs", path="deepseek", requests=32, bursts=s.bursts,
        engine_count=s.host_syncs, seen_in_package=n_seen,
        captures=s.captures, warm_wall_s=f"{wall:.3f}")
    if n_seen != s.host_syncs or s.host_syncs != want or s.captures != 2:
        raise AssertionError(f"deepseek: {n_seen} syncs seen, the engine "
                             f"counts {s.host_syncs}, expected {want}; "
                             f"{s.captures} captures")
    for b, g in sorted(eng.graph_info.items(), reverse=True):
        log("graph", path="deepseek", width=b,
            capture_s=f"{g['capture_s']:.4f}",
            instantiate_s=f"{g['instantiate_s']:.4f}",
            pool_bytes=g["pool_bytes"])
    kernels = counters()
    for k in kernels.values():
        k.launches = 0
    st, wall, _ = run(256, False)
    s = eng.stats
    launches = {name: k.launches for name, k in kernels.items()}
    want = {name: 0 for name in kernels}
    L = model.n_layers
    want.update(mla_decode_attention=s.rounds * L,
                prefill_causal_attention=s.prefills * (L - 1),
                grouped_swiglu=s.rounds * (L - 1) + s.prefills * (L - 2))
    served = sum(len(st.finished[i].tokens) - plens[i] for i in st.finished)
    log("deepseek", path="batch-256", gpu=f"'{gpu_line}'", wall_s=f"{wall:.3f}",
        served=served, tok_s=f"{served / wall:.1f}", rounds=s.rounds,
        prefills=s.prefills, captures=s.captures, slot_rounds=s.slot_rounds,
        expert_rows=s.expert_rows, expert_rows_max=s.expert_rows_max,
        host_syncs=s.host_syncs, draw_s=f"{draw_s:.2f}",
        peak_gb=f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f}",
        **{f"launches_{k}": v for k, v in launches.items() if v})
    if s.captures:
        raise AssertionError("deepseek: the timed run captured a graph")
    if launches != want or not s.rounds or not s.prefills:
        raise AssertionError(f"deepseek launches {launches}, expected {want}")
    return launches


def deepseek_phase(T, dev, gpu_line) -> tuple:
    """[deepseek]: the kernel checks at the cell's shapes, then the model
    whole; the card's memory handed back after. Returns (the kernels
    line's entries of the latent decode kernel and of the grouped SwiGLU,
    a library call; the prefill kernel's readings at 192 / 128, as keys of
    that kernel's entry)."""
    res = deepseek_kernels(dev)
    launches = deepseek_path(T, dev, gpu_line)
    gc.collect()
    torch.cuda.empty_cache()
    dec, pf = res["moe-decode"], res["prefill"]
    return [
        kernel_entry("mla_decode_attention", launches["mla_decode_attention"],
                     [res["mla"]["max_abs_err"]], res["mla"],
                     launches_on="deepseek",
                     max_err_of="each head's largest |out|"),
        {"name": "grouped_swiglu", "route": "torch._grouped_mm",
         "source": "min_llm_inference_tpu_torch/ops/moe.py",
         "replaces": "none: the JAX package has no experts",
         "launches": launches["grouped_swiglu"], "launches_on": "deepseek",
         "max_abs_err": dec["max_abs_err"],
         "max_err_of": "each row's largest |out|", "ms": dec["ms"],
         "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
         **{f"prefill_block_{k}": res["moe-prefill"][k]
            for k in ("ms", "bound_ms", "bound_by")}}], {
        "deepseek_launches": launches["prefill_causal_attention"],
        **{f"dk192_dv128_{k}": pf[k]
           for k in ("max_abs_err", "ms", "bound_ms", "bound_by")}}


def one_slot_case(rng, dev, B, W, P, D, kv, in_dtype, NP, boundary=False):
    """Random one-slot attention inputs as the host scheduler leaves them:
    a shuffled (fragmented) page table, ~10% dead slots whose stale rows
    hold live slots' page ids, q a column slice of one fused [B, 3D]
    projection, lengths covering 1, P-1, P, P+1 and the full width
    (``boundary``: every length a page multiple)."""
    table = rng.permutation(NP)[:B * W].reshape(B, W).astype(np.int32)
    if boundary:
        lengths = (P * rng.integers(1, W + 1, B)).astype(np.int32)
    else:
        lengths = rng.integers(1, W * P + 1, B).astype(np.int32)
        special = [1, P - 1, P, P + 1, W * P]
        lengths[:len(special)] = special
    lengths[5:][rng.random(B - 5) < 0.1] = 0
    live = np.nonzero(lengths > 0)[0]
    for d in np.nonzero(lengths == 0)[0]:
        table[d] = table[rng.choice(live)]
    if kv == "int8":
        pool = rng.integers(-127, 128, (NP, 2, P, D), dtype=np.int8)
    elif kv == "float32":
        pool = rng.standard_normal((NP, 2, P, D), dtype=np.float32)
    qkv = torch.from_numpy(
        rng.standard_normal((B, 3 * D)).astype(np.float32)).to(dev, in_dtype)
    t = {"q": qkv[:, :D],
         "pool": (bf16_pool(rng, dev, (NP, 2, P, D)) if kv == "bfloat16"
                  else torch.from_numpy(pool).to(dev)),
         "lengths": torch.from_numpy(lengths).to(dev),
         "table": torch.from_numpy(table).to(dev), "ks": None, "vs": None}
    if kv == "int8":
        for side in ("ks", "vs"):
            t[side] = torch.from_numpy(
                (rng.random(NP) * 0.05 + 0.001).astype(np.float32)).to(dev)
    return t


def one_slot_bound(lens, calls, B, D, W, P, pool_bytes, q_bytes,
                   scaled) -> tuple:
    """Least time of ``calls`` one-slot calls of B slots whose slot-calls
    had the lengths ``lens`` (0 = dead, clipped to W * P): the L K rows and
    L V rows of each live slot-call (``pool_bytes`` per element) and its q
    (``q_bytes`` per element) read once, o of every slot written in f32,
    the touched pages' scales (when ``scaled``) and table entries and the
    lengths read; 4 f32 operations per context row per feature."""
    lens = np.minimum(np.asarray(lens, dtype=np.int64), W * P)
    live = lens[lens > 0]
    pages = int(np.ceil(live / P).sum())
    nbytes = (int(live.sum()) * 2 * D * pool_bytes
              + live.size * D * q_bytes
              + calls * (B * D * 4 + B * 4)
              + (2 * pages * 4 if scaled else 0)
              + pages * 4)
    return bound_of(nbytes, 4 * int(live.sum()) * D)


def one_slot_call_bound(t) -> tuple:
    """one_slot_bound of one call on the inputs ``t``."""
    B, D = t["q"].shape
    return one_slot_bound(t["lengths"].cpu().numpy(), 1, B, D,
                          t["table"].shape[1], t["pool"].shape[2],
                          t["pool"].element_size(), t["q"].element_size(),
                          t["ks"] is not None)


def check_one_slot(name, t, H, timed, tol=1e-4):
    """One-slot kernel vs its plain version on the inputs ``t``: o within
    tol * max(1, |o|max) (float32 sums in another order), dead slots
    exactly zero, the pool unchanged."""
    from min_llm_inference_tpu_torch.ops.paged_attention import (
        paged_decode_attention as kernel,
        paged_decode_attention_plain as plain,
    )

    args = (t["q"], t["pool"], t["lengths"], t["table"], t["ks"], t["vs"])
    pool0 = t["pool"].clone()
    got = kernel(*args, n_heads=H)
    want = plain(*args, n_heads=H)
    torch.cuda.synchronize()
    if not torch.equal(pool0, t["pool"]):
        raise AssertionError(f"{name}: the pool changed")
    del pool0
    if torch.any(got[t["lengths"] == 0] != 0):
        raise AssertionError(f"{name}: dead slots not exactly zero")
    err = (got - want).abs().max().item()
    lim = tol * max(1.0, want.abs().max().item())
    if not err <= lim:
        raise AssertionError(f"{name}: max |o_kernel - o_plain| {err} > {lim}")
    res = {"max_abs_err": err}
    if timed:
        timed_pair(name, res, lambda: kernel(*args, n_heads=H),
                   lambda: plain(*args, n_heads=H), one_slot_call_bound(t))
        lens = t["lengths"].cpu().numpy()
        res["live_slots"] = int((lens > 0).sum())
        res["mean_live_len"] = float(lens[lens > 0].mean())
    log_result(name, {"o": "close", "dead_rows": "zero"}, res)
    return res


def sample_case(rng, dev, B, V, lengths=None, dead_share=0.25):
    """Float32 logits [B, V] (normal, scale 4), lengths (a quarter dead, or
    the given ones) and a key."""
    logits = torch.from_numpy(
        (rng.standard_normal((B, V), dtype=np.float32) * 4)).to(dev)
    if lengths is None:
        lens = rng.integers(1, MAIN["n_seq"] - 1, B).astype(np.int32)
        lens[rng.random(B) < dead_share] = 0
        lengths = torch.from_numpy(lens).to(dev)
    key = torch.tensor([0, int(rng.integers(0, 2**32))], dtype=torch.int64,
                       device=dev)
    return {"logits": logits, "lengths": lengths, "key": key}


def int32_ops_per_s() -> float:
    """The card's int32 rate: INT32_LANES a clock on each SM at the max SM
    clock that nvidia-smi reports."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_LANES * sms * mhz * 1e6


def sample_bound(t, temperature, top_k, kept) -> dict:
    """The sampling kernel's bounds in ms from this call's inputs: bytes
    (the live rows' float32 logits read once, lengths read, tokens and
    lengths written, the keys) and 32-bit operations: on every element of a
    live row SAMPLE_ROW_F32_OPS and, under top-k, SAMPLE_TOPK_*_OPS; on
    every element it draws (``kept``, the elements at or above the top-k
    threshold, or the whole row) SAMPLE_DRAW_*_OPS. The integer operations
    run at INT32_OPS_PER_S and the float ones at F32_FLOPS, on their own
    lanes: the operation bound is the larger of the two times.
    ``bound_ops_f32_ms`` is all of them over F32_FLOPS, as earlier versions
    of this script counted."""
    B, V = t["logits"].shape
    live = int((t["lengths"] > 0).sum())
    nbytes = live * V * 4 + 3 * B * 4 + 32
    topk = 0 < top_k < V
    int_ops = (live * V * (SAMPLE_TOPK_INT_OPS if topk else 0)
               + kept * SAMPLE_DRAW_INT_OPS)
    f32_ops = (live * V * (SAMPLE_ROW_F32_OPS
                           + (SAMPLE_TOPK_F32_OPS if topk else 0))
               + kept * SAMPLE_DRAW_F32_OPS)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / INT32_OPS_PER_S, f32_ops / F32_FLOPS) * 1e3
    bound = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
             "operations")
    return {"bound": bound, "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
            "bound_ops_f32_ms": (int_ops + f32_ops) / F32_FLOPS * 1e3,
            "int32_ops_per_s": INT32_OPS_PER_S, "live_rows": live,
            "drawn": kept}


def check_sample(name, t, temperature, top_k, timed, want_select=None):
    """The sampling kernel against its plain version on the inputs ``t``:
    its raw draws (the kernel's debug output) equal random_bits(sub) bit for
    bit, its next key the plain split's; tokens and lengths are equal but
    for at most one row whose two best perturbed scores (the plain
    version's) lie within a relative 1e-6 of each other, where the kernel
    took the other of the two (a near-tie, reported). The selects the live
    rows took are counted (``want_select``: every live row must take that
    one)."""
    from min_llm_inference_tpu_torch.ops.random import (
        MASK32, random_bits, split)
    from min_llm_inference_tpu_torch.ops.reference import perturbed_scores
    from min_llm_inference_tpu_torch.ops.sampling import (
        SELECT_CANDIDATES, SELECT_WHOLE_ROW)
    from min_llm_inference_tpu_torch.ops.sampling import (
        sample_next_token as kernel, sample_next_token_plain as plain)

    logits, lengths, key = t["logits"], t["lengths"], t["key"]
    B, V = logits.shape
    kw = dict(n_seq=MAIN["n_seq"], eof_token_id=MAIN["n_vocab"] - 1,
              temperature=temperature, top_k=top_k)
    bits = torch.empty(B, V, dtype=torch.int32, device=logits.device)
    sel = torch.empty(B, dtype=torch.int32, device=logits.device)
    tok, lens, nkey = kernel(logits, lengths, key, bits_out=bits,
                             select_out=sel, **kw)
    ptok, plens, pkey = plain(logits, lengths, key, **kw)
    torch.cuda.synchronize()
    sub = split(key)[1]
    if not torch.equal(bits.long() & MASK32, random_bits(sub, (B, V))):
        raise AssertionError(f"{name}: the kernel's draws differ from "
                             "random_bits")
    del bits
    if not torch.equal(nkey, pkey):
        raise AssertionError(f"{name}: next key {nkey.tolist()} vs "
                             f"{pkey.tolist()}")
    pert = perturbed_scores(logits, sub, temperature, top_k)
    rows = (tok != ptok).nonzero().flatten().tolist()
    gaps = []
    for r in rows:
        top = torch.topk(pert[r], 2)
        gap = float(top.values[0] - top.values[1]) / max(
            abs(float(top.values[0])), 1e-30)
        gaps.append(gap)
        if gap >= 1e-6 or int(tok[r]) not in top.indices.tolist():
            raise AssertionError(f"{name}: row {r} token {int(tok[r])} vs "
                                 f"{int(ptok[r])}, relative gap {gap:.3g}")
    if len(rows) > 1:
        raise AssertionError(f"{name}: {len(rows)} near-ties in one call")
    keep = torch.ones(B, dtype=torch.bool, device=logits.device)
    keep[rows] = False
    if not torch.equal(lens[keep], plens[keep]):
        raise AssertionError(f"{name}: lengths differ")
    live = lengths > 0
    kept = int((torch.isfinite(pert) & live[:, None]).sum())
    del pert
    live_sel = sel[live]
    if want_select is not None and not bool((live_sel == want_select).all()):
        raise AssertionError(f"{name}: selects {live_sel.unique().tolist()}, "
                             f"want {want_select} on every live row")
    res = {"max_abs_err": 0.0, "near_ties": len(rows),
           "select_candidates": int((live_sel == SELECT_CANDIDATES).sum()),
           "select_whole_row": int((live_sel == SELECT_WHOLE_ROW).sum())}
    if gaps:
        res["near_tie_gap"] = gaps[0]
    b = sample_bound(t, temperature, top_k, kept)
    if timed:
        timed_pair(name, res, lambda: kernel(logits, lengths, key, **kw),
                   lambda: plain(logits, lengths, key, **kw), b["bound"])
    res.update({k: v for k, v in b.items() if k != "bound"})
    log_result(name, {"tokens": "== plain", "bits": "identical",
                      "next_key": "identical", "T": temperature,
                      "top_k": top_k}, res)
    return res


def sample_checks(rng, dev) -> list:
    """Phase 3's [sample] checks: every setting at the reference width and
    at GPT-2's vocabulary, 1024 rows with a quarter dead."""
    out = []
    for V in (MAIN["n_vocab"], GPT2_VOCAB):
        t = sample_case(rng, dev, MAIN["n_slots"], V)
        for temperature, top_k in SAMPLE_SETTINGS:
            out.append(check_sample(f"sample-V{V}-T{temperature}-k{top_k}",
                                    t, temperature, top_k, timed=True))
        del t
    return out


def sample_edges(rng, dev) -> list:
    """Phase 3's untimed [sample] edge checks, 64 rows each, and the select
    each must take: ties made by the division (T 3.0, odd top_k: the k-th
    value is one of a merged pair), all-equal rows and rows of -inf with a
    few finite values (the candidates overflow: the whole-row select),
    top_k 31, 32, 33 and V - 1 at V 1000 and 1023, top_k 1 and V - 1 at V
    7 and 31 (lanes with no column), the widths on each side of the
    narrow/wide switch, and a wide row's thread parts (top_k 50) and
    whole-row select (top_k 2000)."""
    from min_llm_inference_tpu_torch.ops import sampling as tsamp
    from min_llm_inference_tpu_torch.tools.sampling_edges import edge_logits

    cand, whole = tsamp.SELECT_CANDIDATES, tsamp.SELECT_WHOLE_ROW
    B, wide = 64, GPT2_VOCAB
    cases = [("ties", 1024, 3.0, 3, cand), ("ties", 1024, 3.0, 15, cand),
             ("ties", wide, 3.0, 15, cand), ("equal", 1024, 1.0, 16, whole),
             ("equal", wide, 1.0, 16, whole), ("ninf", 1024, 1.0, 2, None),
             ("ninf", 1024, 1.0, 16, whole), ("ninf", wide, 1.0, 16, whole)]
    for V in (1000, 1023):
        cases += [("normal", V, 1.5, 31, None), ("normal", V, 1.5, 32, None),
                  ("normal", V, 1.5, 33, whole),
                  ("normal", V, 1.5, V - 1, whole)]
    for V in (7, 31):
        cases += [("normal", V, 1.5, 1, None), ("normal", V, 1.5, V - 1, None)]
    switch = tsamp.narrow_max_v()
    cases += [("normal", switch, 1.5, 16, cand),
              ("normal", switch + 1, 1.5, 16, cand),
              ("normal", wide, 1.5, 50, cand),
              ("normal", wide, 1.5, 2000, whole)]
    out = []
    for kind, V, temperature, top_k, want in cases:
        t = sample_case(rng, dev, B, V)
        if kind != "normal":
            t["logits"] = torch.from_numpy(edge_logits(
                kind, int(rng.integers(2**31)), B, V, temperature)).to(dev)
        out.append(check_sample(f"sample-edge-{kind}-V{V}-T{temperature}"
                                f"-k{top_k}", t, temperature, top_k,
                                timed=False, want_select=want))
    return out


def sample_switch(rng, dev) -> dict:
    """The sampling kernel's device time (device_ev_ms) with a warp per row
    and with a block per row (the launcher's path forced), 1024 rows (a
    quarter dead) at each of SWITCH_WIDTHS and SWITCH_TOP_K, T 1.5: the
    data behind the launcher's switch at narrow_max_v() columns. Then the
    whole-row select's cost: all-equal rows at the reference width and at
    GPT-2's vocabulary, top_k 16."""
    from min_llm_inference_tpu_torch.ops import sampling as tsamp
    from min_llm_inference_tpu_torch.tools.sampling_edges import edge_logits

    kw = dict(n_seq=MAIN["n_seq"], eof_token_id=MAIN["n_vocab"] - 1,
              temperature=1.5)
    out = {}
    for V in SWITCH_WIDTHS:
        t = sample_case(rng, dev, MAIN["n_slots"], V)
        args = (t["logits"], t["lengths"], t["key"], kw["n_seq"],
                kw["eof_token_id"], kw["temperature"])
        for top_k in SWITCH_TOP_K:
            ms = {}
            for path, code in (("narrow", tsamp.PATH_NARROW),
                               ("wide", tsamp.PATH_WIDE)):
                ms[path] = device_ev_ms(lambda: tsamp._launch(
                    *args, top_k, None, None, code))
                out[f"switch_V{V}_k{top_k}_{path}_ms"] = ms[path]
            log("sample-switch", V=V, top_k=top_k,
                narrow_ms=f"{ms['narrow']:.6g}", wide_ms=f"{ms['wide']:.6g}",
                narrow_max_v=tsamp.narrow_max_v())
    for V in (MAIN["n_vocab"], GPT2_VOCAB):
        t = sample_case(rng, dev, MAIN["n_slots"], V)
        logits = torch.from_numpy(edge_logits(
            "equal", 0, MAIN["n_slots"], V)).to(dev)
        ms = device_ev_ms(lambda: tsamp.sample_next_token(
            logits, t["lengths"], t["key"], top_k=16, **kw))
        out[f"whole_row_V{V}_ms"] = ms
        log("sample-switch", case=f"whole-row-equal-V{V}", top_k=16,
            device_ev_ms=f"{ms:.6g}")
    return out


def check_probe(dev):
    """The int4 probe through its entry point (strict: it raises unless the
    kernel ran and equals its plain version), with every launch counter
    set to 0 just before it; then its kernel vs the plain version (exactly
    equal: every sum of quarter-integer products is exact in float32),
    timed beside its bound and beside ``torch.matmul`` on the dequantized
    page, which leaves out the unpack. Returns (entry-point launches,
    result)."""
    from min_llm_inference_tpu_torch.ops.quant import unpack_int4
    from min_llm_inference_tpu_torch.tools import int4_probe as pr

    kernels = counters()
    for k in kernels.values():
        k.launches = 0
    pr.probe(dev, strict=True)
    launches = kernels["int4_page_self_dot"].launches
    if launches != 1 or sum(k.launches for k in kernels.values()) != 1:
        raise AssertionError(f"probe launches {launches}")
    x = pr.make_pages(1).to(dev)
    got = pr.int4_page_self_dot(x)
    want = pr.int4_page_self_dot_plain(x)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("int4 probe: kernel differs from the plain "
                             "version")
    n, P, Dk = x.shape
    D = 2 * Dk
    res = {"max_abs_err": 0.0}
    # page 0 read once, [P, P] f32 written; P*P*D multiply-adds, on the
    # int8 tensor cores
    timed_pair("int4-probe", res, lambda: pr.int4_page_self_dot(x),
               lambda: pr.int4_page_self_dot_plain(x),
               bound_of(P * Dk + P * P * 4, 2 * P * P * D, INT8_TENSOR_OPS))
    xf = unpack_int4(x[0], 1) * pr.SCALE
    res["library_ms"] = time_ms(lambda: torch.matmul(xf, xf.t()), 20)
    # the library call's device time alone, beside the kernel's
    res["library_device"] = {}
    DEVICE_PENDING.append(("int4-probe-matmul", res["library_device"],
                           lambda: torch.matmul(xf, xf.t())))
    # the yardstick on the kernel's footing: the device time of the unpack
    # and torch.matmul together (the plain version), beside the kernel's
    res["yardstick"] = {}
    DEVICE_PENDING.append(("int4-probe-unpack+matmul", res["yardstick"],
                           lambda: pr.int4_page_self_dot_plain(x)))
    log_result("int4-probe", {"out": "equal"}, res)
    return launches, res


# ---------------------------------------------------------------- phases 4-6


def numpy_init_params(rng, model, eof_bias):
    """Uniform(-1, 1) * 0.02 weights with an EOF bias and unit LayerNorm
    gains: the recipe (and draw order) of the JAX package's init_params,
    drawn from a numpy generator."""
    def u(shape):
        return (rng.uniform(-1.0, 1.0, shape) * 0.02).astype(np.float32)

    V, D, F = model.n_vocab, model.emb_dim, model.ffn_dim
    wte = u((V, D))
    wte[model.eof_token_id] += eof_bias
    tree = {"wte": wte, "wpe": u((model.n_seq, D)), "layers": []}
    for _ in range(model.n_layers):
        layer = {"wq": u((D, D)), "wk": u((D, D)), "wv": u((D, D))}
        if model.use_output_proj:
            layer["wo"] = u((D, D))
        if F > 0:
            layer["w_up"] = u((D, F))
            layer["w_down"] = u((F, D))
        if model.use_layernorm:
            layer["ln1_g"] = np.ones(D, np.float32)
            layer["ln2_g"] = np.ones(D, np.float32)
        tree["layers"].append(layer)
    return tree


def parity(T, dev, model, params, cfg, prompts, label):
    """The engine's kernel path ("grouped") against its gather oracle
    ("torch", which never takes the ring), token for token, each on the
    graph. Each engine runs the prompts twice: the first run captures its
    graphs (after an eager warm-up burst per width, whose launches count
    too), the second replays them and is the one held and counted.
    Returns the generated token count, the kernel path's stats and the
    launches by kernel name of both engines' second runs."""
    from min_llm_inference_tpu_torch import bench as tbench

    outs, stats = {}, None
    kernels = counters()
    launches = {name: 0 for name in kernels}
    for impl in ("grouped", "torch"):
        eng = T.AutonomousEngine(params, model, cfg, attention_impl=impl,
                                 device=dev)
        eng.run(tbench.make_store(prompts))
        eng.stats = T.BurstStats()
        before = {name: k.launches for name, k in kernels.items()}
        store = tbench.make_store(prompts)
        eng.run(store)
        for name, k in kernels.items():
            launches[name] += k.launches - before[name]
        stats = stats or eng.stats
        outs[impl] = [store.finished[i].tokens for i in range(len(prompts))]
    if outs["grouped"] != outs["torch"]:
        first = next(i for i in range(len(prompts))
                     if outs["grouped"][i] != outs["torch"][i])
        raise AssertionError(f"engine parity {label}: request {first} "
                             f"{outs['grouped'][first]} vs "
                             f"{outs['torch'][first]}")
    return (sum(len(o) - len(p) for o, p in zip(outs["grouped"], prompts)),
            stats, launches)


def engine_parity(T, dev) -> tuple:
    """Phase 4. Returns the grouped kernel's mode-(c) launches (the ring
    configs with dgrid off) at float32, int8 and int4 KV, and the
    attention kernels' launches at bf16 KV by kernel name."""
    model = T.ModelConfig(n_vocab=256, emb_dim=32, n_seq=64, eof_token_id=255)
    params = T.params_from_numpy(
        numpy_init_params(np.random.default_rng(1), model, 0.05), model, dev)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 255, int(rng.integers(1, 24))).tolist()
               for _ in range(24)]
    bf16 = collections.Counter()
    for kv in ("int4", "int8", "float32", "bfloat16"):
        cfg = T.EngineConfig(n_slots=8, page_size=16, n_pages=32,
                             n_forward_rounds=4, subbursts=2, kv_dtype=kv,
                             decode_ring=False)
        n_gen, _, launched = parity(T, dev, model, params, cfg, prompts, kv)
        if kv == "bfloat16":
            bf16.update(launched)
        log("engine", kv=kv, requests=len(prompts), generated=n_gen,
            tokens="grouped == torch")
    # ring decode on a small gpt2s-shaped model (multi-head, LN, wo, FFN)
    gmodel = T.ModelConfig(n_vocab=256, emb_dim=64, n_seq=64, n_layers=2,
                           n_heads=4, ffn_dim=128, use_output_proj=True,
                           use_layernorm=True, eof_token_id=255)
    gparams = T.params_from_numpy(
        numpy_init_params(np.random.default_rng(3), gmodel, 0.05), gmodel, dev)
    mode_c = 0
    for kv, extra in (("int8", dict(attn_dgrid=True, sort_admits=True)),
                      ("int8", dict(subbursts=2)),
                      ("int4", dict(subbursts=2, burst_flush=False)),
                      ("float32", dict(attn_dgrid=True)),
                      ("bfloat16", dict(subbursts=2)),
                      ("bfloat16", dict(attn_dgrid=True)),
                      ("bfloat16", dict(attn_flat=True, subbursts=2))):
        cfg = T.EngineConfig(n_slots=8, page_size=16, n_pages=32,
                             n_forward_rounds=4, kv_dtype=kv,
                             decode_ring=True, **extra)
        label = f"ring-{kv}-" + "-".join(f"{k}={v}" for k, v in extra.items())
        n_gen, _, launched = parity(T, dev, gmodel, gparams, cfg, prompts,
                                    label)
        names = ("paged_decode_attention_grouped", "dgrid_paged_partial",
                 "ring_flush", "prefill_quant_scatter",
                 "paged_decode_attention_flat")
        got = [launched[n] for n in names]
        attn = 1 if cfg.attn_dgrid else 4 if cfg.attn_flat else 0
        if got[2] == 0 or any((got[i] > 0) != (i == attn) for i in (0, 1, 4)):
            raise AssertionError(f"{label}: launches grouped/dgrid/flush/"
                                 f"prefill/flat {got} do not fit the config")
        if kv == "bfloat16":
            bf16.update(dict(zip(names, got)))
        else:
            mode_c += got[0]
        log("engine", case=label, requests=len(prompts), generated=n_gen,
            tokens="grouped == torch",
            launches_grouped_dgrid_flush_prefill_flat="/".join(map(str, got)))
    return mode_c, bf16


def variant_parity(T, dev) -> int:
    """Phase 4, the rest of AutonomousEngine's options: ring decode on the
    flat partial (f32, int8, int4 KV; 1 and 2 heads) and on the dense view
    (f32, int8, int4), and overcommit with forced preemption (4 half-groups
    for 8 slots whose requests run to the cap) without the ring, with the
    ring on mode (c) and on the flat partial (f32, int8). Each kernel path
    equals the gather oracle token for token and launches its attention
    kernel once per round and layer (the dense view is plain PyTorch and
    launches none); every overcommit config preempts. Returns the flat
    kernel's launches."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 255, int(rng.integers(1, 24))).tolist()
               for _ in range(24)]
    # tiny prompts on a model without an EOF bias: they run to the 64-token
    # cap, every slot needs both halves, so growth must preempt
    capped = [rng.integers(0, 254, 2).tolist() for _ in range(12)]
    models = {}
    for H, emb, eof_bias in ((1, 32, 0.05), (2, 32, 0.05), ("oc", 64, 0.0)):
        m = T.ModelConfig(n_vocab=256, emb_dim=emb, n_seq=64, eof_token_id=255,
                          n_heads=1 if H == "oc" else H)
        models[H] = (m, T.params_from_numpy(numpy_init_params(
            np.random.default_rng(emb + len(models)), m, eof_bias), m, dev))
    base = dict(n_slots=8, page_size=16, n_pages=32, n_forward_rounds=4)
    cases = []
    for H in (1, 2):
        for kv in ("float32", "int8", "int4"):
            cases.append((f"ring-flat-{kv}-H{H}", H, prompts, dict(
                kv_dtype=kv, decode_ring=True, attn_flat=True, subbursts=2),
                "paged_decode_attention_flat"))
    for kv in ("float32", "int8", "int4"):
        cases.append((f"ring-dense-{kv}", 2, prompts, dict(
            kv_dtype=kv, decode_ring=True, attn_dense=True), None))
    for kv in ("float32", "int8"):
        for ring, extra, kname in (
                ("no-ring", dict(decode_ring=False),
                 "paged_decode_attention_grouped"),
                ("ring-c", dict(decode_ring=True),
                 "paged_decode_attention_grouped"),
                ("ring-flat", dict(decode_ring=True, attn_flat=True),
                 "paged_decode_attention_flat")):
            cases.append((f"overcommit-{ring}-{kv}", "oc", capped, dict(
                kv_dtype=kv, n_pages=8, init_num_pages=2, overcommit=True,
                **extra), kname))
    attention = ("paged_decode_attention_grouped",
                 "paged_decode_attention_flat", "dgrid_paged_partial",
                 "paged_decode_attention")
    flat = 0
    for label, H, ps, extra, kname in cases:
        model, params = models[H]
        cfg = T.EngineConfig(**{**base, **extra})
        n_gen, st, launched = parity(T, dev, model, params, cfg, ps, label)
        got = {n: launched[n] for n in attention}
        want = {n: 0 for n in attention}
        if kname:
            want[kname] = st.rounds * model.n_layers
        flushes = launched["ring_flush"]
        if got != want or (flushes > 0) != cfg.decode_ring or (
                cfg.overcommit and st.preemptions == 0):
            raise AssertionError(
                f"{label}: attention launches {got}, expected {want}; "
                f"{flushes} flushes; {st.preemptions} preemptions")
        flat += got["paged_decode_attention_flat"]
        log("engine", case=label, requests=len(ps), generated=n_gen,
            tokens="grouped == torch", rounds=st.rounds,
            preemptions=st.preemptions, flushes=flushes,
            **{f"launches_{n}": v for n, v in got.items() if v})
    return flat


def host_parity(T, dev) -> tuple:
    """Phase 4, host engines: PagedEngine's kernel paths ("paged", the
    one-slot kernel; "grouped", the fused-write kernel over fragmented
    tables) against its gather oracle ("torch"), token for token, for
    float32, int8 and bfloat16 KV, in a roomy config and one that
    preempts; then DenseEngine against PagedEngine("torch") on float32.
    Each kernel path must launch its kernel once per round and layer.
    Returns the one-slot kernel's launches at float32 and int8 KV, and
    the kernels' launches at bf16 KV by kernel name."""
    from min_llm_inference_tpu_torch import bench as tbench

    kernels = counters()
    model = T.ModelConfig(n_vocab=256, emb_dim=32, n_seq=64, eof_token_id=255)
    params = T.params_from_numpy(
        numpy_init_params(np.random.default_rng(1), model, 0.05), model, dev)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 255, int(rng.integers(1, 40))).tolist()
               for _ in range(24)]
    one_slot = 0
    bf16 = collections.Counter()
    for kv in ("float32", "int8", "bfloat16"):
        for label, extra in (("roomy", {}),
                             ("pressure", dict(n_pages=6, init_num_pages=1))):
            cfg = T.EngineConfig(**{**dict(
                n_slots=8, page_size=16, n_pages=32, n_forward_rounds=4,
                kv_dtype=kv, max_prefill_batch=4, decode_ring=False), **extra})
            outs, stats = {}, {}
            for impl, kname in (("torch", None),
                                ("paged", "paged_decode_attention"),
                                ("grouped", "paged_decode_attention_grouped")):
                for k in kernels.values():
                    k.launches = 0
                store = tbench.make_store(prompts)
                eng = T.PagedEngine(params, model, cfg, attention_impl=impl,
                                    device=dev)
                eng.run(store)
                outs[impl] = [store.finished[i].tokens
                              for i in range(len(prompts))]
                stats[impl] = eng.stats
                got = {n: k.launches for n, k in kernels.items()
                       if k.launches}
                want = {kname: eng.stats.rounds} if kname else {}
                if kv == "int8":   # n_seq 64, a page multiple: page writes
                    want["prefill_quant_scatter"] = eng.stats.prefills
                if got != want:
                    raise AssertionError(f"host {kv} {label} {impl}: launches "
                                         f"{got}, expected {want}")
                if kv == "bfloat16":
                    bf16.update(got)
                elif impl == "paged":
                    one_slot += got.get(kname, 0)
            for impl in ("paged", "grouped"):
                if outs[impl] != outs["torch"]:
                    first = next(i for i in range(len(prompts))
                                 if outs[impl][i] != outs["torch"][i])
                    raise AssertionError(
                        f"host parity {kv} {label}: {impl} request {first} "
                        f"{outs[impl][first]} vs {outs['torch'][first]}")
            pre = stats["paged"].preemptions
            if (label == "pressure") != (pre > 0):
                raise AssertionError(f"host {kv} {label}: {pre} preemptions")
            log("engine", host=f"PagedEngine-{kv}-{label}",
                requests=len(prompts), bursts=stats["paged"].bursts,
                preemptions=pre,
                generated=sum(len(o) - len(p)
                              for o, p in zip(outs["torch"], prompts)),
                tokens="paged == grouped == torch")
    cfg = T.EngineConfig(n_slots=8, page_size=16, n_pages=32,
                         n_forward_rounds=4, max_prefill_batch=4,
                         decode_ring=False)
    outs = {}
    for name, make in (("dense", lambda: T.DenseEngine(params, model, cfg,
                                                       device=dev)),
                       ("paged", lambda: T.PagedEngine(
                           params, model, cfg, attention_impl="torch",
                           device=dev))):
        store = tbench.make_store(prompts)
        make().run(store)
        outs[name] = [store.finished[i].tokens for i in range(len(prompts))]
    if outs["dense"] != outs["paged"]:
        raise AssertionError("DenseEngine differs from PagedEngine(torch)")
    log("engine", host="DenseEngine-float32", requests=len(prompts),
        tokens="dense == paged-torch")
    return one_slot, bf16


def counters():
    """The launch counter of every kernel wrapper, by kernel name."""
    from min_llm_inference_tpu_torch.ops import mla_decode as md
    from min_llm_inference_tpu_torch.ops import moe
    from min_llm_inference_tpu_torch.ops import paged_attention as pa
    from min_llm_inference_tpu_torch.ops import paged_attention_dgrid as dg
    from min_llm_inference_tpu_torch.ops import paged_attention_flat as fl
    from min_llm_inference_tpu_torch.ops import paged_attention_grouped as gr
    from min_llm_inference_tpu_torch.ops import prefill_attention as pfa
    from min_llm_inference_tpu_torch.ops import prefill_scatter as ps
    from min_llm_inference_tpu_torch.ops import ring_flush as rf
    from min_llm_inference_tpu_torch.ops import sampling as sa
    from min_llm_inference_tpu_torch.tools import int4_probe as pr

    return {"paged_decode_attention_grouped": gr.paged_decode_attention_grouped,
            "dgrid_paged_partial": dg.dgrid_paged_partial,
            "ring_flush": rf.ring_flush,
            "prefill_quant_scatter": ps.prefill_quant_scatter,
            "paged_decode_attention": pa.paged_decode_attention,
            "paged_decode_attention_flat": fl.paged_decode_attention_flat,
            "int4_page_self_dot": pr.int4_page_self_dot,
            "sample_next_token": sa.sample_next_token,
            "prefill_causal_attention": pfa.prefill_causal_attention,
            "mla_decode_attention": md.mla_decode_attention,
            "grouped_swiglu": moe.grouped_swiglu}


def make_prompts(n, seed, V):
    """bench.py's request stream: prompts uniform in [1, 64] over the
    vocabulary without EOF, from a generator of ``seed``."""
    from min_llm_inference_tpu_torch.bench import draw_prompts

    return draw_prompts(np.random.default_rng(seed), n, 64, V)


def drive(T, dev, params, model, cfg, n, seed, engine_kw, count_syncs=False,
          engine_cls=None, engine=None):
    """One engine run of ``n`` requests, timed by the host clock around
    work that ends synchronized: ``engine`` (its stats from zero), else a
    new AutonomousEngine on its kernel path ("grouped"), or ``engine_cls``
    with ``engine_kw``. With count_syncs, PyTorch's sync debug mode records
    every device sync of the run; the engine gets ``syncs_seen`` (those
    made from the package's code) and ``sync_sites``."""
    from min_llm_inference_tpu_torch import bench as tbench

    store = tbench.make_store(make_prompts(n, seed, model.n_vocab))
    if engine is not None:
        eng = engine
        eng.stats = T.BurstStats()
    elif engine_cls is None:
        eng = T.AutonomousEngine(params, model, cfg, attention_impl="grouped",
                                 device=dev, **engine_kw)
    else:
        eng = engine_cls(params, model, cfg, device=dev, **engine_kw)
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


def auto_runner(T, dev, params, model, cfg, engine_kw, dot_dir):
    """run(n, seed, count_syncs=False, capture=True) of an AutonomousEngine
    path: one engine on the CUDA graph (its graphs written to ``dot_dir``
    for their node counts) and one on the eager path (``capture=False``,
    the check path that reads the gate and the bucket on the host), each
    made at its first run and kept, so that a later run of the same queue
    shape replays the first run's graphs."""
    engines = {}

    def run(n, seed, count_syncs=False, capture=True):
        if capture not in engines:
            engines[capture] = T.AutonomousEngine(
                params, model, cfg, attention_impl="grouped", device=dev,
                _capture=capture, _graph_dot_dir=dot_dir if capture else None,
                **engine_kw)
        return drive(T, dev, params, model, cfg, n, seed, engine_kw,
                     count_syncs, engine=engines[capture])

    return run


def warm_and_check_syncs(run, label):
    """A 64-request warm run: the engine's first, so it captures one graph
    per executed width (after an eager burst per width that runs every
    branch: cuBLAS handles, allocator pools, kernel libraries). PyTorch's
    sync debug mode sees every sync of the run; the engine must account
    for each one made from the package's code (all sites are printed), and
    makes none inside a burst: two uploads, one status read per chunk and
    the final pull. One [graph] line per captured width."""
    warm, _, _ = run(64, seed=1, count_syncs=True)
    st = warm.stats
    want = 2 + -(-st.bursts // warm.chunk) + 1
    log("syncs", path=label, requests=64, bursts=st.bursts,
        chunks=-(-st.bursts // warm.chunk), engine_count=st.host_syncs,
        seen_in_package=warm.syncs_seen, captures=st.captures,
        sites=warm.sync_sites)
    if warm.syncs_seen != st.host_syncs or st.host_syncs != want:
        raise AssertionError(f"{label}: {warm.syncs_seen} device syncs in "
                             f"the run, the engine accounts for "
                             f"{st.host_syncs}, expected {want}")
    if st.captures != len(warm.graph_info) or not st.captures:
        raise AssertionError(f"{label}: {st.captures} captures")
    for b, g in sorted(warm.graph_info.items(), reverse=True):
        log("graph", path=label, width=b, capture_s=f"{g['capture_s']:.4f}",
            instantiate_s=f"{g['instantiate_s']:.4f}",
            pool_bytes=g["pool_bytes"], nodes=g["nodes"])
    return st.host_syncs, st.bursts


def graph_vs_eager(label, eng, store, wall, e_eng, e_store, e_wall):
    """The timed run on the graph against the same request stream on the
    eager path, token for token; one [graph] line with both walls."""
    for rid, req in store.finished.items():
        if e_store.finished[rid].tokens != req.tokens:
            raise AssertionError(f"{label}: request {rid} differs between "
                                 "the graph and the eager path")
    log("graph", path=label, requests=len(store.finished),
        tokens="graph == eager", graph_wall_s=f"{wall:.4f}",
        eager_wall_s=f"{e_wall:.4f}", graph_bursts=eng.stats.bursts,
        eager_bursts=e_eng.stats.bursts,
        graph_syncs_per_burst=f"{eng.stats.host_syncs / eng.stats.bursts:.3f}",
        eager_syncs_per_burst=
        f"{e_eng.stats.host_syncs / e_eng.stats.bursts:.3f}")


def check_outputs(store, n_req, S, V):
    """Every request finished with 1..S-plen valid tokens; returns the
    generated token count."""
    if len(store.finished) != n_req:
        raise AssertionError(f"{len(store.finished)}/{n_req} requests "
                             "finished")
    total = 0
    for req in store.finished.values():
        gen = req.tokens[req.prompt_len:]
        if not gen or len(req.tokens) > S or not all(0 <= x < V for x in gen):
            raise AssertionError(f"request {req.id}: bad output {gen[:8]}")
        total += len(gen)
    return total


def ref_engine(**cfg_kw) -> tuple:
    """Phase 5's engine config (under the options ``cfg_kw``) and engine
    options, as dicts."""
    cfg = dict(n_slots=MAIN["n_slots"], n_pages=MAIN["n_pages"],
               n_forward_rounds=16, page_size=MAIN["page_size"],
               init_num_pages=2, max_prefill_batch=128, subbursts=2)
    cfg.update(cfg_kw)
    return cfg, dict(max_new_per_burst=512, bursts_per_chunk=24,
                     request_capacity=MAIN["requests"])


def gpt2s_engine(**cfg_kw) -> dict:
    """Phase 6's engine config (under the options ``cfg_kw``), as a
    dict."""
    g = GPT2S
    cfg = dict(n_slots=g["n_slots"], n_pages=g["n_pages"],
               page_size=g["page_size"], n_forward_rounds=16,
               init_num_pages=2, kv_dtype="int8", max_prefill_batch=128,
               decode_ring=True, attn_dgrid=True, sort_admits=True,
               subbursts=1, burst_flush=True)
    cfg.update(cfg_kw)
    return cfg


def ref_model_run(T, dev, label, dot_dir, params=None, engine_extra=None,
                  **cfg_kw):
    """The reference-parity model, request stream and engine options of
    phase 5 under the engine options ``cfg_kw`` and ``engine_extra`` (the
    sampling options), on bench.py's weights or ``params``: (model, cfg,
    run(n, seed, count_syncs, capture), the warm run's (host syncs,
    bursts)), after the warm run's sync check."""
    from min_llm_inference_tpu_torch import bench as tbench

    model = tbench.ref_model()
    cfg_d, engine_kw = ref_engine(**cfg_kw)
    cfg = T.EngineConfig(**cfg_d)
    if params is None:
        params = tbench.ref_params(dev)
    engine_kw.update(engine_extra or {})
    run = auto_runner(T, dev, params, model, cfg, engine_kw, dot_dir)
    warm = warm_and_check_syncs(run, label)
    return model, cfg, run, warm


def timed_run(run, n_req, want_of, label):
    """The timed run of a path (``n_req`` requests, seed 2), a replay of
    the warm run's graphs: every launch counter set to 0 just before it,
    read just after and held against ``want_of(stats)`` (launches by
    kernel name; every kernel not named must launch 0 times). Returns
    (engine, store, wall, launches)."""
    kernels = counters()
    for k in kernels.values():
        k.launches = 0
    eng, store, wall = run(n_req, seed=2)
    if eng.stats.captures:
        raise AssertionError(f"{label}: the timed run captured instead of "
                             "replaying the warm run's graphs")
    launches = {name: k.launches for name, k in kernels.items()}
    want = {name: 0 for name in kernels}
    want.update(want_of(eng.stats))
    if launches != want or 0 in want_of(eng.stats).values():
        raise AssertionError(f"{label} launches {launches}, expected {want}")
    return eng, store, wall, launches


def main_path(T, dev, gpu_line, dot_dir, profile_dir=None, kv="int4",
              label="main"):
    """Phase 5 (and [bf16-kv] (i) at ``kv`` "bfloat16", logged under
    ``label``): the reference path at full width. Returns (the fused-write
    kernel's launches in the timed run, the replayed call's result, (the
    graph engine, the timed run's store, its wall, the warm run's host
    syncs and bursts))."""
    model, cfg, run, warm = ref_model_run(T, dev, label, dot_dir,
                                          kv_dtype=kv, decode_ring=False)
    D, S, n_req = model.emb_dim, model.n_seq, MAIN["requests"]
    eng, store, wall, counts = timed_run(run, n_req, lambda st: {
        "paged_decode_attention_grouped": st.rounds * model.n_layers}, label)
    PATH_WALLS[label] = wall
    launches = counts["paged_decode_attention_grouped"]
    st = eng.stats
    total = check_outputs(store, n_req, S, model.n_vocab)
    # the kernel's bound over the whole run, from the contexts its calls
    # saw: a request is live in the calls at lengths plen .. final-1
    ctx = np.concatenate([np.arange(r.prompt_len, len(r.tokens))
                          for r in store.finished.values()])
    W = cfg.pages_per_slot(S)
    run_bound, _ = grouped_bound(
        ctx, launches, cfg.n_slots, D, D // 2 if cfg.kv_packed else D, W,
        cfg.page_size, 2, cfg.kv_torch_dtype.itemsize, cfg.kv_quantized)
    log(label, requests=n_req, generated=total, wall_s=f"{wall:.4f}",
        tok_s=f"{total / wall:.1f}", gpu=f"'{gpu_line}'", kv_dtype=kv,
        bursts=st.bursts, skipped=st.skipped, rounds=st.rounds,
        kernel_launches=launches,
        host_syncs_per_burst=f"{st.host_syncs / st.bursts:.3f}",
        mean_live_context=f"{ctx.mean():.2f}",
        mean_live_slots_per_launch=f"{ctx.size / launches:.1f}",
        kernel_bound_ms_per_launch=f"{run_bound / launches:.6g}")
    # one call of that run's request stream on the eager path (which equals
    # the graph token for token) replayed on its real inputs: kernel vs
    # plain
    call_ix = launches // 2
    snaps, eager = capture_calls(lambda: run(n_req, seed=2, capture=False), {
        "grouped": ("models.paged", "paged_decode_attention_grouped",
                    call_ix)})
    graph_vs_eager(label, eng, store, wall, *eager)
    args, kw = snaps["grouped"]
    names = ("q", "pool", "lengths", "table", "ks", "vs", "k_new", "v_new")
    res = check_grouped(f"{label}-path-call-{call_ix}",
                        dict(zip(names, args), kw=kw), timed=True)
    res["run_bound_ms_per_launch"] = run_bound / launches
    if profile_dir:
        PROFILE_PENDING.append((lambda: run(n_req, seed=2), wall, label))
    return launches, res, (eng, store, wall, warm)


def gpt2s_path(T, dev, gpu_line, dot_dir, profile_dir=None):
    """Phase 6: the gpt2s path at full width. Returns (launches by kernel
    name of the timed run, {kernel name: replayed-call result})."""
    from min_llm_inference_tpu_torch import bench as tbench

    g = GPT2S
    V, S, L = g["n_vocab"], g["n_seq"], g["n_layers"]
    n_req = g["requests"]
    model = tbench.gpt2s_model()
    cfg = T.EngineConfig(**gpt2s_engine())
    from min_llm_inference_tpu_torch.models.params import params_checksum

    # bench.py's own weights, made on the card (phase 13)
    t0 = time.perf_counter()
    params = T.init_params(0, model, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    checksum = params_checksum(params)
    log("params", model="gpt2s", seed=0, init_s=f"{init_s:.3f}",
        leaves=2 + sum(len(layer) for layer in params["layers"]),
        sha256=checksum,
        jax_sha256=GPT2S_INIT_SHA256,
        equal="yes" if checksum == GPT2S_INIT_SHA256 else "NO")
    if checksum != GPT2S_INIT_SHA256:
        raise AssertionError("params: init_params(0, gpt2s) on the card is "
                             "not JAX's init_params(PRNGKey(0), gpt2s)")
    engine_kw = dict(max_new_per_burst=512, bursts_per_chunk=6,
                     min_drain_slots=512, request_capacity=n_req)
    run = auto_runner(T, dev, params, model, cfg, engine_kw, dot_dir)
    warm_and_check_syncs(run, "gpt2s")
    eng, store, wall, launches = timed_run(run, n_req, lambda st: {
        "dgrid_paged_partial": st.rounds * L,
        "ring_flush": (st.bursts - st.skipped) * L,
        "prefill_quant_scatter": st.prefills * L,
        "prefill_causal_attention": st.prefills * (L - 1)}, "gpt2s")
    PATH_WALLS["gpt2s"] = wall
    st = eng.stats
    total = check_outputs(store, n_req, S, V)
    log("gpt2s", requests=n_req, generated=total, wall_s=f"{wall:.4f}",
        tok_s=f"{total / wall:.1f}", gpu=f"'{gpu_line}'",
        bursts=st.bursts, skipped=st.skipped, rounds=st.rounds,
        prefills=st.prefills,
        host_syncs_per_burst=f"{st.host_syncs / st.bursts:.3f}",
        **{f"launches_{k}": v for k, v in launches.items()})
    # the middle call of each kernel of that run, replayed on its inputs
    names = ("dgrid_paged_partial", "ring_flush", "prefill_quant_scatter")
    calls = {"dgrid_paged_partial": ("models.paged", "dgrid_paged_partial"),
             "ring_flush": ("runtime.autonomous", "ring_flush"),
             "prefill_quant_scatter": ("models.paged",
                                       "prefill_quant_scatter")}
    snaps, eager = capture_calls(lambda: run(n_req, seed=2, capture=False), {
        n: (*calls[n], launches[n] // 2) for n in names})
    graph_vs_eager("gpt2s", eng, store, wall, *eager)
    res = {}
    args, kw = snaps["dgrid_paged_partial"]
    q, pool, ks, vs, rs, lens, table = args
    res["dgrid_paged_partial"] = check_partial(
        f"gpt2s-dgrid-call-{launches['dgrid_paged_partial'] // 2}", "dgrid",
        {"q": q, "pool": pool, "ks": ks, "vs": vs, "rs": rs, "lengths": lens,
         "table": table, "packed": False}, kw["n_heads"], timed=True)
    args, kw = snaps["ring_flush"]
    pool, ring, rs, lens, table = args
    res["ring_flush"] = check_flush(
        f"gpt2s-flush-call-{launches['ring_flush'] // 2}",
        {"pool": pool, "ring": ring, "rs": rs, "lengths": lens,
         "table": table, "n_rounds": kw["n_rounds"], "r0": kw["ring_r0"]},
        timed=True)
    args, _ = snaps["prefill_quant_scatter"]
    res["prefill_quant_scatter"] = check_prefill(
        f"gpt2s-prefill-call-{launches['prefill_quant_scatter'] // 2}",
        dict(zip(("pool", "k", "v", "pid", "inv_k", "inv_v"), args)),
        timed=True)
    if profile_dir:
        PROFILE_PENDING.append((lambda: run(n_req, seed=2), wall, "gpt2s"))
    return launches, res


def host_path(T, dev, gpu_line, profile_dir=None):
    """Phase 7: the host-scheduled path at full width, as ``python bench.py
    --engine host --attention pallas`` runs the JAX package: PagedEngine's
    Python page scheduler and two-deep pipelined loop on the one-slot
    kernel, the reference-parity model and request stream of phase 5 with
    int8 paged KV. Returns (launches by kernel name of the timed run,
    {kernel name: replayed-call result})."""
    from min_llm_inference_tpu_torch import bench as tbench
    from min_llm_inference_tpu_torch.utils.profiling import (
        get_global_phase_stats,
    )

    V, D, S, P = (MAIN["n_vocab"], MAIN["emb_dim"], MAIN["n_seq"],
                  MAIN["page_size"])
    n_req = MAIN["requests"]
    model = tbench.ref_model()
    cfg = T.EngineConfig(n_slots=MAIN["n_slots"], n_pages=MAIN["n_pages"],
                         n_forward_rounds=16, page_size=P, init_num_pages=2,
                         kv_dtype="int8", max_prefill_batch=128,
                         decode_ring=False, subbursts=2)
    params = tbench.ref_params(dev)

    def run(n, seed, count_syncs=False, engine_cls=T.PagedEngine):
        return drive(T, dev, params, model, cfg, n, seed,
                     dict(attention_impl="paged"), count_syncs, engine_cls)

    # warm run: the loop's one sync per burst is its wait on the pulled
    # results' event, which the engine counts; sync debug mode must see no
    # other sync from the package (uploads are pinned and non-blocking)
    warm, _, _ = run(64, seed=1, count_syncs=True)
    wst = warm.stats
    log("syncs", path="host", requests=64, bursts=wst.bursts,
        pulls=wst.host_syncs, uploads=wst.uploads,
        seen_in_package=warm.syncs_seen, sites=warm.sync_sites)
    if warm.syncs_seen != 0 or wst.host_syncs != wst.bursts:
        raise AssertionError(f"host: {warm.syncs_seen} hidden syncs, "
                             f"{wst.host_syncs} pulls for {wst.bursts} bursts")
    kernels = counters()
    for k in kernels.values():
        k.launches = 0
    phases = get_global_phase_stats()
    phases.reset()
    eng, store, wall = run(n_req, seed=2)
    PATH_WALLS["host"] = wall
    host_s = phase_seconds(phases)
    launches = {name: k.launches for name, k in kernels.items()}
    st = eng.stats
    total = check_outputs(store, n_req, S, V)
    want = {name: 0 for name in kernels}
    want["paged_decode_attention"] = st.rounds * model.n_layers
    want["prefill_quant_scatter"] = st.prefills * model.n_layers
    if 0 in (st.rounds, st.prefills) or launches != want:
        raise AssertionError(f"host launches {launches}, expected {want}")
    n_launch = launches["paged_decode_attention"]
    # the live slot-calls of the run: one per generated token, at the
    # context length it was generated from
    ctx = np.concatenate([np.arange(r.prompt_len, len(r.tokens))
                          for r in store.finished.values()])
    run_bound, _ = one_slot_bound(
        ctx, n_launch, cfg.n_slots, D, cfg.pages_per_slot(S), P,
        getattr(torch, cfg.kv_dtype).itemsize,
        getattr(torch, model.dtype).itemsize, cfg.kv_dtype == "int8")
    log("host", requests=n_req, generated=total, wall_s=f"{wall:.4f}",
        tok_s=f"{total / wall:.1f}", gpu=f"'{gpu_line}'",
        iterations=st.bursts, rounds=st.rounds, prefills=st.prefills,
        preemptions=st.preemptions,
        syncs_per_iteration=f"{st.host_syncs / st.bursts:.3f}",
        uploads_per_iteration=f"{st.uploads / st.bursts:.3f}",
        kernel_launches=n_launch,
        mean_live_context=f"{ctx.mean():.2f}",
        mean_live_slots_per_launch=f"{ctx.size / n_launch:.1f}",
        kernel_bound_ms_per_launch=f"{run_bound / n_launch:.6g}",
        host_phase_s=host_s)
    # the middle call of each kernel of that run, replayed on its inputs
    snaps, _ = capture_calls(lambda: run(n_req, seed=2), {
        "paged_decode_attention": ("models.paged", "paged_decode_attention",
                                   n_launch // 2),
        "prefill_quant_scatter": ("models.paged", "prefill_quant_scatter",
                                  launches["prefill_quant_scatter"] // 2)})
    args, kw = snaps["paged_decode_attention"]
    res = {"paged_decode_attention": check_one_slot(
        f"host-call-{n_launch // 2}",
        dict(zip(("q", "pool", "lengths", "table", "ks", "vs"), args)),
        kw["n_heads"], timed=True)}
    one = res["paged_decode_attention"]
    one["run_bound_ms_per_launch"] = run_bound / n_launch
    # its device time here, in the middle of the script, beside the one
    # device_times() takes at the end on the same inputs
    one["device_ev_ms_mid"] = device_ev_ms(DEVICE_PENDING[-1][2])
    log("kernel_device", case=f"host-call-{n_launch // 2}", at="mid",
        device_ev_ms=f"{one['device_ev_ms_mid']:.6g}")
    args, _ = snaps["prefill_quant_scatter"]
    res["prefill_quant_scatter"] = check_prefill(
        f"host-prefill-call-{launches['prefill_quant_scatter'] // 2}",
        dict(zip(("pool", "k", "v", "pid", "inv_k", "inv_v"), args)),
        timed=True)
    # the native scheduler on the same request stream: the same tokens
    phases.reset()
    n_eng, n_store, n_wall = run(n_req, seed=2,
                                 engine_cls=T.NativePagedEngine)
    native_s = phase_seconds(phases)
    n_total = check_outputs(n_store, n_req, S, V)
    for rid, req in store.finished.items():
        if n_store.finished[rid].tokens != req.tokens:
            raise AssertionError(f"native request {rid} differs from the "
                                 "Python-scheduled run")
    log("host", engine="NativePagedEngine", requests=n_req,
        generated=n_total, wall_s=f"{n_wall:.4f}",
        tok_s=f"{n_total / n_wall:.1f}", gpu=f"'{gpu_line}'",
        iterations=n_eng.stats.bursts, preemptions=n_eng.stats.preemptions,
        host_phase_s=native_s, tokens="native == python")
    if profile_dir:
        PROFILE_PENDING.append((lambda: run(n_req, seed=2), wall, "host"))
    return launches, res


def flat_path(T, dev, gpu_line, dot_dir, profile_dir=None):
    """Phase 8: the reference model with int4 KV on the decode ring (one
    ring across 2 sub-bursts, one flush per burst) and the flat partial.
    Returns (launches by kernel name of the timed run, {kernel name:
    replayed-call result})."""
    model, cfg, run, _ = ref_model_run(
        T, dev, "flat", dot_dir, kv_dtype="int4", decode_ring=True,
        burst_flush=True, attn_flat=True)
    L = model.n_layers
    eng, store, wall, launches = timed_run(run, MAIN["requests"], lambda st: {
        "paged_decode_attention_flat": st.rounds * L,
        "ring_flush": (st.bursts - st.skipped) * L}, "flat")
    st = eng.stats
    total = check_outputs(store, MAIN["requests"], model.n_seq, model.n_vocab)
    log("flat", requests=MAIN["requests"], generated=total,
        wall_s=f"{wall:.4f}", tok_s=f"{total / wall:.1f}",
        gpu=f"'{gpu_line}'", bursts=st.bursts, skipped=st.skipped,
        rounds=st.rounds, prefills=st.prefills,
        host_syncs_per_burst=f"{st.host_syncs / st.bursts:.3f}",
        **{f"launches_{k}": v for k, v in launches.items() if v})
    # the middle flat and flush calls of that run, replayed on their inputs
    n_flat = launches["paged_decode_attention_flat"]
    n_flush = launches["ring_flush"]
    snaps, eager = capture_calls(
        lambda: run(MAIN["requests"], seed=2, capture=False), {
            "flat": ("models.paged", "paged_decode_attention_flat",
                     n_flat // 2),
            "flush": ("runtime.autonomous", "ring_flush", n_flush // 2)})
    graph_vs_eager("flat", eng, store, wall, *eager)
    args, kw = snaps["flat"]
    names = ("q", "pool", "lengths", "table", "ks", "vs", "rs")
    res = {"paged_decode_attention_flat": check_partial(
        f"flat-call-{n_flat // 2}", "flat",
        {**dict(zip(names, args)), "packed": kw["packed_int4"]},
        kw["n_heads"], timed=True)}
    args, kw = snaps["flush"]
    res["ring_flush"] = check_flush(
        f"flat-flush-call-{n_flush // 2}",
        dict(zip(("pool", "ring", "rs", "lengths", "table"), args),
             n_rounds=kw["n_rounds"], r0=kw["ring_r0"]), timed=True)
    if profile_dir:
        PROFILE_PENDING.append((lambda: run(MAIN["requests"], seed=2), wall,
                                "flat"))
    return launches, res


def overcommit_path(T, dev, gpu_line, dot_dir, profile_dir=None):
    """Phase 9: the reference model with int8 KV, no ring, under
    overcommit on OVERCOMMIT_PAGES pages. The timed run must preempt.
    Returns (launches by kernel name of the timed run, the replayed
    fused-write call's result, preemptions)."""
    model, cfg, run, _ = ref_model_run(
        T, dev, "overcommit", dot_dir, kv_dtype="int8", decode_ring=False,
        overcommit=True, n_pages=OVERCOMMIT_PAGES)
    L = model.n_layers
    eng, store, wall, launches = timed_run(run, MAIN["requests"], lambda st: {
        "paged_decode_attention_grouped": st.rounds * L,
        "prefill_quant_scatter": st.prefills * L}, "overcommit")
    PATH_WALLS["overcommit"] = wall
    st = eng.stats
    total = check_outputs(store, MAIN["requests"], model.n_seq, model.n_vocab)
    units = cfg.n_pages // (cfg.pages_per_slot(model.n_seq) // 2)
    log("overcommit", requests=MAIN["requests"], generated=total,
        wall_s=f"{wall:.4f}", tok_s=f"{total / wall:.1f}",
        gpu=f"'{gpu_line}'", pages=cfg.n_pages, half_units=units,
        slots=cfg.n_slots, preemptions=st.preemptions, bursts=st.bursts,
        skipped=st.skipped, rounds=st.rounds, prefills=st.prefills,
        host_syncs_per_burst=f"{st.host_syncs / st.bursts:.3f}",
        **{f"launches_{k}": v for k, v in launches.items() if v})
    if st.preemptions == 0:
        raise AssertionError(f"overcommit on {cfg.n_pages} pages never "
                             "preempted")
    n_call = launches["paged_decode_attention_grouped"] // 2
    snaps, eager = capture_calls(
        lambda: run(MAIN["requests"], seed=2, capture=False), {
            "grouped": ("models.paged", "paged_decode_attention_grouped",
                        n_call)})
    graph_vs_eager("overcommit", eng, store, wall, *eager)
    args, kw = snaps["grouped"]
    names = ("q", "pool", "lengths", "table", "ks", "vs", "k_new", "v_new")
    res = check_grouped(f"overcommit-call-{n_call}",
                        dict(zip(names, args), kw=kw), timed=True)
    if profile_dir:
        PROFILE_PENDING.append((lambda: run(MAIN["requests"], seed=2), wall,
                                "overcommit"))
    return launches, res, st.preemptions


def serve_stream(T, eng, prompts):
    """StreamingSession on ``eng`` (its own buffers and graph, captured
    when it is made) serves ``prompts``: waves of STREAM_WAVE submitted
    whenever the ring of STREAM_CAPACITY rows has room, one burst
    dispatched per step, each burst's status and final_lens observed two
    bursts later, completions polled from those snapshots. Returns
    ({request id: request}, the session, seconds to make it, serving wall,
    waves)."""
    n_req = len(prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess = T.StreamingSession(eng, capacity=STREAM_CAPACITY,
                              max_prompt_len=64, observe_lag=2)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    done, submitted, waves, steps = {}, 0, 0, 0
    t0 = time.perf_counter()
    while len(done) < n_req:
        take = min(STREAM_WAVE, n_req - submitted)
        if take and sess.free_capacity >= take:
            sess.submit([T.Request(i, list(prompts[i]))
                         for i in range(submitted, submitted + take)])
            submitted += take
            waves += 1
        sess.dispatch()
        steps += 1
        s = sess.observe()
        if s is not None and s["finished_total"]:
            for r in sess.poll(s["fin_lens"], s["n_submitted_at"]):
                done[r.id] = r
        if steps > 20 * n_req:
            raise AssertionError(f"stream: {len(done)}/{n_req} finished")
    for r in sess.close():
        done[r.id] = r
    torch.cuda.synchronize()
    return done, sess, setup_s, time.perf_counter() - t0, waves


def stream_path(T, gpu_line, eng, oneshot):
    """Phase 10: online serving at the reference path's configuration.
    StreamingSession on the main path's graph engine serves phase 5's 2048
    requests (serve_stream). Every request must equal the one-shot timed
    run's tokens."""
    V = MAIN["n_vocab"]
    n_req = MAIN["requests"]
    kernels = counters()
    for k in kernels.values():
        k.launches = 0
    done, sess, setup_s, wall, waves = serve_stream(
        T, eng, make_prompts(n_req, 2, V))
    total = 0
    for rid, req in done.items():
        if req.tokens != oneshot.finished[rid].tokens:
            raise AssertionError(f"stream: request {rid} differs from the "
                                 "one-shot run")
        total += len(req.tokens) - req.prompt_len
    st = sess.stats
    log("stream", requests=n_req, generated=total, wall_s=f"{wall:.4f}",
        tok_s=f"{total / wall:.1f}", setup_s=f"{setup_s:.4f}",
        capacity=STREAM_CAPACITY, waves=waves, bursts=st.bursts,
        skipped=st.skipped, rounds=st.rounds,
        host_syncs_per_burst=f"{st.host_syncs / st.bursts:.3f}",
        tokens="stream == one-shot", gpu=f"'{gpu_line}'",
        **{f"launches_{k}": v.launches for k, v in kernels.items()
           if v.launches})


def tokens_of(store) -> dict:
    return {rid: r.tokens for rid, r in store.finished.items()}


def main_sample_path(T, dev, gpu_line, dot_dir, greedy, profile_dir=None):
    """Phase 11: the main path with sampled decoding (SAMPLE_KW) on the
    reference model with init_params(0) weights, the draws made by the
    sampling kernel inside the burst's graph. ``greedy``: the
    main path's (wall, warm-run host syncs and bursts). Returns (launches
    by kernel name of the timed run, the replayed sampling call's results
    at the reference width and at GPT-2's vocabulary)."""
    from min_llm_inference_tpu_torch import bench as tbench

    # the JAX package's init_params recipe (uniform(-1, 1) * 0.02) for the
    # reference model: bench.py's uniform(0, 1) weights make the logit gaps
    # so wide that Gumbel noise at T = 1.5 never moves an argmax (seeds 7
    # and 8 gave the same 2048 requests), and the path would be greedy
    params = T.init_params(0, tbench.ref_model(), device=dev)
    model, cfg, run, warm = ref_model_run(
        T, dev, "main-sample", dot_dir, params=params, engine_extra=SAMPLE_KW,
        kv_dtype="int4", decode_ring=False)
    main_wall, main_warm = greedy
    if warm != main_warm:
        raise AssertionError(f"main-sample: warm run (host syncs, bursts) "
                             f"{warm}, the greedy main path's {main_warm}")
    S, V, n_req, L = model.n_seq, model.n_vocab, MAIN["requests"], 1
    eng, store, wall, launches = timed_run(run, n_req, lambda st: {
        "paged_decode_attention_grouped": st.rounds * L,
        "sample_next_token": st.rounds}, "main-sample")
    st = eng.stats
    total = check_outputs(store, n_req, S, V)
    tokens = tokens_of(store)
    _, again, _ = run(n_req, seed=2)
    if tokens_of(again) != tokens:
        raise AssertionError("main-sample: a second run with seed 7 differs")
    other = auto_runner(T, dev, params, model, cfg, dict(
        max_new_per_burst=512, bursts_per_chunk=24, request_capacity=n_req,
        **{**SAMPLE_KW, "sample_seed": 8}), None)
    _, seed8, _ = other(n_req, seed=2)
    n_differ = sum(seed8.finished[r].tokens != t for r, t in tokens.items())
    if not n_differ:
        raise AssertionError("main-sample: seed 8 gave seed 7's tokens")
    log("main-sample", requests=n_req, generated=total, wall_s=f"{wall:.4f}",
        tok_s=f"{total / wall:.1f}", greedy_wall_s=f"{main_wall:.4f}",
        gpu=f"'{gpu_line}'", bursts=st.bursts, skipped=st.skipped,
        rounds=st.rounds, prefills=st.prefills,
        host_syncs_per_burst=f"{st.host_syncs / st.bursts:.3f}",
        warm_syncs_bursts=f"{warm[0]}/{warm[1]}", seed7_rerun="identical",
        seed8_requests_differing=n_differ,
        **{f"launches_{k}": v for k, v in launches.items() if v})
    # the middle sampling call of that request stream on the eager path,
    # replayed on its inputs, and the same live rows at GPT-2's vocabulary
    n_call = launches["sample_next_token"] // 2
    snaps, eager = capture_calls(lambda: run(n_req, seed=2, capture=False), {
        "sample": ("runtime.autonomous", "sample_next_token", n_call)})
    graph_vs_eager("main-sample", eng, store, wall, *eager)
    (logits, lengths, key), kw = snaps["sample"]
    t = {"logits": logits, "lengths": lengths, "key": key}
    res = {"ref": check_sample(f"main-sample-call-{n_call}", t,
                               kw["temperature"], kw["top_k"], timed=True)}
    wide = sample_case(np.random.default_rng(3), dev, logits.shape[0],
                       GPT2_VOCAB, lengths=lengths)
    wide["key"] = key
    res["gpt2"] = check_sample(f"main-sample-call-{n_call}-V{GPT2_VOCAB}",
                               wide, kw["temperature"], kw["top_k"],
                               timed=True)
    del wide
    # the sampled stream: one submission pattern twice, token-identical
    prompts = make_prompts(n_req, 2, V)
    runs = []
    for _ in range(2):
        done, sess, setup_s, s_wall, waves = serve_stream(T, eng, prompts)
        runs.append({rid: r.tokens for rid, r in done.items()})
    if runs[0] != runs[1] or len(runs[0]) != n_req:
        raise AssertionError("main-sample: the sampled stream is not "
                             "reproducible")
    log("stream", path="main-sample", requests=n_req,
        wall_s=f"{s_wall:.4f}", setup_s=f"{setup_s:.4f}", waves=waves,
        bursts=sess.stats.bursts,
        host_syncs_per_burst=
        f"{sess.stats.host_syncs / sess.stats.bursts:.3f}",
        tokens="run 1 == run 2", gpu=f"'{gpu_line}'")
    if profile_dir:
        PROFILE_PENDING.append((lambda: run(n_req, seed=2), wall,
                                "main-sample"))
    return launches, res


def dequantized(tree):
    """The dense bfloat16 tree of a weight-quantized one: each {"q",
    "scale"} leaf through dequantize_weight (the same matrices the
    quantized leaves are read as)."""
    from min_llm_inference_tpu_torch.ops.quant import (
        dequantize_weight, is_quantized_leaf)

    def conv(x):
        if is_quantized_leaf(x):
            return dequantize_weight(x["q"], x["scale"], torch.bfloat16)
        return x

    return {"wte": conv(tree["wte"]), "wpe": conv(tree["wpe"]),
            "layers": [{k: conv(v) for k, v in layer.items()}
                       for layer in tree["layers"]]}


def weights_path(T, dev, gpu_line, dot_dir, main_wall,
                 profile_dir=None) -> None:
    """Phase 12: the main path on int8, then fp8, weight-only quantized
    weights (quantize_params of bench.py's bf16 weights), each token-exact
    with the same path on the dense bf16 tree dequantize_weight makes of
    the same leaves; one [weights] line each with both walls and the
    greedy main path's."""
    from min_llm_inference_tpu_torch import bench as tbench

    n_req = MAIN["requests"]
    for mode in ("int8", "fp8"):
        qtree = T.quantize_params(tbench.ref_params(dev), mode)
        out = {}
        for form, tree in (("quantized", qtree),
                           ("dense", dequantized(qtree))):
            model, _, run, _ = ref_model_run(
                T, dev, f"weights-{mode}-{form}", dot_dir, params=tree,
                kv_dtype="int4", decode_ring=False)
            eng, store, wall, _ = timed_run(run, n_req, lambda st: {
                "paged_decode_attention_grouped": st.rounds},
                f"weights-{mode}-{form}")
            out[form] = (tokens_of(store), wall, eng.stats, store)
            if profile_dir and form == "quantized":
                PROFILE_PENDING.append((lambda run=run: run(n_req, seed=2),
                                        wall, f"weights-{mode}"))
        if out["quantized"][0] != out["dense"][0]:
            first = next(r for r, t in out["quantized"][0].items()
                         if out["dense"][0][r] != t)
            raise AssertionError(f"weights-{mode}: request {first} differs "
                                 "from the dequantized dense tree")
        total = check_outputs(out["quantized"][3], n_req, model.n_seq,
                              model.n_vocab)
        q_wall, d_wall = out["quantized"][1], out["dense"][1]
        st = out["quantized"][2]
        log("weights", mode=mode, requests=n_req, generated=total,
            wall_s=f"{q_wall:.4f}", tok_s=f"{total / q_wall:.1f}",
            dense_bf16_wall_s=f"{d_wall:.4f}",
            main_bf16_wall_s=f"{main_wall:.4f}",
            tokens="quantized == dequantized dense", bursts=st.bursts,
            rounds=st.rounds, gpu=f"'{gpu_line}'")


def phase_seconds(stats) -> str:
    """The engine's host seconds per phase (utils.profiling.phase), e.g.
    ``forward:0.41,process_results:0.52``; ``forward`` is the enqueue of
    the bursts, ``process_results`` includes the wait on each pull."""
    return ",".join(f"{name}:{v['seconds']:.4f}"
                    for name, v in stats.summary().items())


def capture_calls(run, targets):
    """Run once more with call sites wrapped and return (for each target
    ``label: (module under the package, attribute, call index)`` a copy,
    strides kept, of the positional and keyword arguments of that call,
    taken before the call writes anything; what run() returned). The run
    must be eager: a graph replay calls no wrapper."""
    import importlib

    def copy(x):
        if not isinstance(x, torch.Tensor):
            return x
        y = torch.empty_strided(x.size(), x.stride(), dtype=x.dtype,
                                device=x.device)
        return y.copy_(x)

    patched, snaps = [], {}
    for label, (mod_name, attr, call_ix) in targets.items():
        mod = importlib.import_module(f"min_llm_inference_tpu_torch.{mod_name}")
        real = getattr(mod, attr)
        calls = [0]

        def wrapped(*args, _real=real, _calls=calls, _ix=call_ix,
                    _label=label, **kw):
            if _calls[0] == _ix:
                snaps[_label] = ([copy(a) for a in args],
                                 {k: copy(v) for k, v in kw.items()})
            _calls[0] += 1
            return _real(*args, **kw)

        setattr(mod, attr, wrapped)
        patched.append((mod, attr, real, calls))
    try:
        result = run()
    finally:
        # last wrapped first: two targets may wrap one attribute
        for mod, attr, real, _ in reversed(patched):
            setattr(mod, attr, real)
    missing = [label for label in targets if label not in snaps]
    if missing:
        raise AssertionError(f"the replay made "
                             f"{[c[0] for *_, c in patched]} calls, none at "
                             f"the index of {missing}")
    return snaps, result


def profile_path(run, out_dir, wall_unprofiled, label):
    """One more run under torch.profiler: device time by kernel (device-side
    kernel and copy events only: the CPU ops and the phase ranges also carry
    device time and would count it twice) and the sum's share of the
    profiled and of the unprofiled wall, into DIR/<label>_kernels.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = run()
    from min_llm_inference_tpu_torch.utils.profiling import \
        get_global_phase_stats

    # every engine phase the run entered (utils/profiling.phase)
    phases = set(get_global_phase_stats().seconds)
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key in phases:
            continue
        us = getattr(e, "self_device_time_total", 0)
        if us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    with open(os.path.join(out_dir, f"{label}_kernels.txt"), "w") as f:
        for us, key, count in rows:
            f.write(f"{us / 1e3:12.3f} ms {count:8d}  {key}\n")
    log("profile", path=label, wall_s=f"{wall:.4f}",
        device_busy_s=f"{busy_s:.4f}", busy_share=f"{busy_s / wall:.4f}",
        busy_share_of_unprofiled=f"{busy_s / wall_unprofiled:.4f}",
        launches=sum(r[2] for r in rows),
        top=";".join(f"{k[:48]}={us / 1e3:.2f}ms/{n}"
                     for us, k, n in rows[:8]))


# ---------------------------------------------------------------- mesh


def mesh_launch_want(label, r, n_layers):
    """The launches a mesh rank's run must show, from its stats."""
    st = r["stats"]
    if label == "ref":
        return {"paged_decode_attention_grouped": st["rounds"] * n_layers}
    return {"dgrid_paged_partial": st["rounds"] * n_layers,
            "ring_flush": (st["bursts"] - st["skipped"]) * n_layers,
            "prefill_quant_scatter": st["prefills"] * n_layers}


def check_mesh_ranks(label, mesh, ranks, want_tokens, n_layers,
                     difference=None):
    """Every rank holds every request; tokens equal ``want_tokens`` (with
    ``difference(rid, got)``: a request that differs on rank 0 is measured
    by it, not refused here); each rank's launches match its stats (no
    other kernel launched). Returns the launches summed over the ranks and
    rank 0's differences."""
    diffs = []
    for r in ranks:
        if len(r["tokens"]) != len(want_tokens):
            raise AssertionError(f"{label} {mesh}: rank {r['rank']} holds "
                                 f"{len(r['tokens'])}/{len(want_tokens)}")
        for rid, toks in want_tokens.items():
            if r["tokens"][rid] != toks:
                if difference is None:
                    raise AssertionError(f"{label} {mesh}: request {rid} "
                                         f"differs on rank {r['rank']}")
                if r["rank"] == 0:
                    diffs.append(difference(rid, r["tokens"][rid]))
        need = mesh_launch_want(label, r, n_layers)
        want = {k: 0 for k in r["launches"]}
        want.update(need)
        if r["launches"] != want or 0 in need.values():
            raise AssertionError(f"{label} {mesh}: rank {r['rank']} "
                                 f"launches {r['launches']}, expected {want}")
    total = collections.Counter()
    for r in ranks:
        total.update(r["launches"])
    return dict(total), diffs


def mesh_log(label, mesh, ranks, launches, gpu_line, **extra):
    r0 = ranks[0]
    st = r0["stats"]
    log(f"mesh-{label}", mesh=mesh, graphed=r0["graphed"],
        wall_s=";".join(f"{w:.4f}" for w in r0["walls"]),
        slowest_rank_wall_s=f"{max(r['walls'][-1] for r in ranks):.4f}",
        bursts=st["bursts"], skipped=st["skipped"], rounds=st["rounds"],
        host_syncs_per_burst=f"{st['host_syncs'] / st['bursts']:.3f}",
        launches=",".join(f"{k}:{v}" for k, v in launches.items() if v),
        gpu=f"'{gpu_line}'", **extra)


def mesh_tp_setup(T, dev):
    """[mesh-tp]'s case: the gpt2s path's model and engine (phase 6) in
    float32 with init_params(0) weights, without the drain downshift (the
    JAX mesh engine has none), MESH_TP_REQUESTS requests, and the
    single-chip engine's tokens on them (the oracle)."""
    from min_llm_inference_tpu_torch import bench as tbench

    model_d = dataclasses.asdict(tbench.gpt2s_model(dtype="float32"))
    cfg = gpt2s_engine()
    kw = dict(max_new_per_burst=512, bursts_per_chunk=6,
              request_capacity=MESH_TP_REQUESTS)
    model = T.ModelConfig(**model_d)
    params = T.init_params(0, model, device=dev)
    eng, store, wall = drive(T, dev, params, model, T.EngineConfig(**cfg),
                             MESH_TP_REQUESTS, 3, kw)
    log("mesh-tp-single", requests=MESH_TP_REQUESTS, wall_s=f"{wall:.4f}",
        bursts=eng.stats.bursts, note="single-chip oracle, float32 gpt2s")
    return dict(model_d=model_d, cfg=cfg, kw=kw, model=model, params=params,
                prompts=make_prompts(MESH_TP_REQUESTS, 3, model.n_vocab),
                want=tokens_of(store))


def tp_call(case, tp):
    """A [mesh-tp] rank's call: the case at ``tp`` (engine_run times its
    all-reduces)."""
    return ("engine_run", dict(
        kind="auto", model=case["model_d"], engine=case["cfg"],
        recipe=("init", 0, 0.0), prompts=case["prompts"], tp=tp,
        attention="grouped", runs=1, engine_kw=case["kw"]))


def tp_difference(T, case, rid, got):
    """A request that differs from the single-chip tokens: its first
    differing token's top-2 gap in the plain f32 logits, and the logit
    noise int8 KV makes there (the largest change of a logit when K and V
    go through the page quantization). Returns (gap, noise)."""
    from min_llm_inference_tpu_torch.tools.fuzz_draws import plain_logits

    want = case["want"][rid]
    j = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    f32 = plain_logits(case["params"], case["model"], want[:j])
    i8 = plain_logits(case["params"], case["model"], want[:j], "int8",
                      case["cfg"]["page_size"])
    top = torch.topk(f32, 2)
    gap = float(top.values[0] - top.values[1])
    noise = float((i8 - f32).abs().max())
    log("mesh-tp-tie", request=rid, token=j, tokens=f"{want[j]}->{got[j]}",
        top2=",".join(str(int(x)) for x in top.indices), gap=f"{gap:.4g}",
        int8_kv_noise=f"{noise:.4g}", gap_over_noise=f"{gap / noise:.3f}")
    return gap, noise


def collective_fields(r) -> dict:
    """A tp rank's timed all-reduces (workers._time_collectives) as log
    fields: by op, calls, the wait for the rank's device work, the reduce,
    and calls x the fastest reduce (the reduce's own cost, without the
    wait for the peer); ``rest_s``: the wall's remainder, the rank's host
    work (eager dispatch, scheduling)."""
    by_op = collections.defaultdict(lambda: [0, 0.0, 0.0, 0.0])
    for op, shape, calls, wait, red, fastest in r["collectives"]:
        t = by_op[op]
        t[0] += calls
        t[1] += wait
        t[2] += red
        t[3] += calls * fastest
    wait = sum(t[1] for t in by_op.values())
    red = sum(t[2] for t in by_op.values())
    return dict(
        allreduce=";".join(
            f"{op}:{c}calls/wait{w:.3f}s/reduce{x:.3f}s/fastest{f:.3f}s"
            for op, (c, w, x, f) in sorted(by_op.items())),
        device_wait_s=f"{wait:.3f}", reduce_s=f"{red:.3f}",
        rest_s=f"{r['walls'][-1] - wait - red:.3f}")


def check_tp(T, case, mesh, ranks, gpu_line, label="tp"):
    """[mesh-tp]'s verdict on one mesh: each request that differs from
    the single-chip engine must be a near-tie (gap below NEAR_TIE x the
    int8 KV noise), and at most MESH_TP_MAX_DIFFERING may differ. Logs the
    mesh line (with rank 0's timed all-reduces) before it raises. Returns
    the launches."""
    model = case["model"]
    got, diffs = check_mesh_ranks(
        "tp", mesh, ranks, case["want"], model.n_layers,
        lambda rid, toks: tp_difference(T, case, rid, toks))
    ratios = [g / n for g, n in diffs]
    mesh_log(label, mesh, ranks, got, gpu_line, tokens="mesh vs single-chip",
             differing=len(diffs),
             max_gap_over_noise=f"{max(ratios):.3f}" if ratios else "-",
             requests=MESH_TP_REQUESTS,
             cut=f"requests {MESH_TP_REQUESTS} of {GPT2S['requests']}",
             **collective_fields(ranks[0]))
    far = [r for r in ratios if not r < NEAR_TIE]
    if far or len(diffs) > MESH_TP_MAX_DIFFERING:
        raise AssertionError(
            f"mesh-tp {mesh}: {len(diffs)} requests differ (at most "
            f"{MESH_TP_MAX_DIFFERING}), {len(far)} of them at a top-2 gap "
            f"not below {NEAR_TIE} x the int8 KV noise")
    return got


def mesh_tp_only(T, dev, gpu_line):
    """``--only mesh-tp``: [mesh-tp] alone (tp = 2, then dp = 2 x tp = 2,
    ranks on the one card under gloo)."""
    from min_llm_inference_tpu_torch.parallel import run_ranks, workers

    case = mesh_tp_setup(T, dev)
    for world, mesh in ((2, "tp2 gloo"), (4, "dp2xtp2 gloo")):
        results = run_ranks(workers.run_cases, world, ([tp_call(case, 2)],),
                            share_device=True, timeout=600)
        check_tp(T, case, mesh, [r[0] for r in results], gpu_line)


def mesh_stage(T, dev, gpu_line, ref_store):
    """Phase 17: the mesh engines (parallel/), their ranks spawned by
    parallel/launch.run_ranks after every timed phase (the libraries built
    in phase 2). [mesh-ref]: ShardedAutonomousEngine on the main path
    (phase 5's model, weights, engine and 2048 requests) at world size 1
    (NCCL) and dp = 2, 4 on the one card (gloo, share_device; tp = 1, so
    each rank's burst is a CUDA graph), twice each (capture, then replay),
    token for token against phase 5's timed run. [mesh-tp]: the gpt2s
    widths in float32 at tp = 2 and dp = 2 x tp = 2 (ranks on the card
    under gloo, eager bursts) against the single-chip engine on the same
    256 requests (check_tp: near-ties only, at most
    MESH_TP_MAX_DIFFERING). [mesh-nccl]: the tp check across cards
    under NCCL where there are two, else a line that says why not.
    [mesh-dryrun]: the package's dryrun at N = 4. Returns the launches of
    every mesh run by kernel name."""
    from min_llm_inference_tpu_torch import bench as tbench
    from min_llm_inference_tpu_torch.dryrun import dryrun
    from min_llm_inference_tpu_torch.parallel import run_ranks, workers

    rmodel = tbench.ref_model()
    # the main path's engine (phase 5)
    ref_cfg, ref_kw = ref_engine(kv_dtype="int4", decode_ring=False)
    V = rmodel.n_vocab
    ref_prompts = make_prompts(MAIN["requests"], 2, V)
    ref_tree = tbench.bench_tree(np.random.default_rng(0), rmodel)
    ref_want = tokens_of(ref_store)
    ref_call = ("engine_run", dict(
        kind="auto", model=dataclasses.asdict(rmodel), engine=ref_cfg,
        recipe=("numpy", ref_tree), prompts=ref_prompts, tp=1,
        attention="grouped", runs=2, engine_kw=ref_kw))
    case = mesh_tp_setup(T, dev)

    launches = collections.Counter()
    # world size 1 under NCCL; then dp 2 and 4 (with the tp meshes of the
    # same world size) on the one card under gloo
    plan = [(1, False, [("ref", "dp1 nccl", ref_call)]),
            (2, True, [("ref", "dp2 gloo", ref_call),
                       ("tp", "tp2 gloo", tp_call(case, 2))]),
            (4, True, [("ref", "dp4 gloo", ref_call),
                       ("tp", "dp2xtp2 gloo", tp_call(case, 2))])]
    for world, share, runs in plan:
        t0 = time.perf_counter()
        results = run_ranks(workers.run_cases, world,
                            ([c for *_, c in runs],), share_device=share,
                            timeout=600)
        spawn_s = time.perf_counter() - t0
        for k, (label, mesh, _) in enumerate(runs):
            ranks = [r[k] for r in results]
            if label == "ref":
                got, _ = check_mesh_ranks("ref", mesh, ranks, ref_want, 1)
                mesh_log("ref", mesh, ranks, got, gpu_line,
                         tokens="mesh == main", spawn_s=f"{spawn_s:.1f}")
            else:
                got = check_tp(T, case, mesh, ranks, gpu_line)
            launches.update(got)
    if torch.cuda.device_count() >= 2:
        results = run_ranks(workers.run_cases, 2, ([tp_call(case, 2)],),
                            timeout=600)
        launches.update(check_tp(T, case, "tp2 nccl",
                                 [r[0] for r in results], gpu_line,
                                 label="nccl"))
    else:
        log("mesh-nccl", ran="no",
            reason=f"{torch.cuda.device_count()} card: NCCL across cards "
                   "needs two")
    t0 = time.perf_counter()
    line, results = dryrun(4, "cuda", timeout=600)
    got = collections.Counter()
    for rank in results:
        for r in rank:
            got.update(r["launches"])
    for name in ("paged_decode_attention", "paged_decode_attention_grouped",
                 "ring_flush", "prefill_quant_scatter"):
        if not got[name]:
            raise AssertionError(f"mesh-dryrun: {name} never launched")
    log("mesh-dryrun", wall_s=f"{time.perf_counter() - t0:.2f}",
        launches=",".join(f"{k}:{v}" for k, v in got.items() if v),
        result=f"'{line}'")
    launches.update(got)
    return dict(launches)


# ---------------------------------------------------------------- bf16 KV


def bf16_checks(rng, dev) -> dict:
    """Phase 3 at bfloat16 pools, each kernel against its plain version on
    the card (pool bytes bit-identical after the fused write, outputs and
    partials within 1e-4 x max(1, |x|)), the timed ones beside their bound
    (the pool at 2 B a feature): the grouped kernel's modes (a), (b) and
    (c) at the reference path's shapes (1024 slots, emb 2048, one head, P
    32, 4096 pages); the one-slot kernel at the host path's; dgrid and
    flat at the gpt2s path's (12 heads of 64); flat at the reference
    ring's; then the edges: the one-slot and the grouped modes at
    12-head contexts of W*P = 4096 and at rows of 8192 features in one
    head, the fused write with the new row at every position class of a
    tile and a page, five times over one pool, and heads of 5 features
    (2-byte reads). Returns {check: result} and the errors by kernel."""
    P = MAIN["page_size"]
    W = -(-MAIN["n_seq"] // P)
    B, D, NP = MAIN["n_slots"], MAIN["emb_dim"], MAIN["n_pages"]
    g = GPT2S
    gshape = (g["n_slots"], W, g["page_size"], g["emb_dim"])
    bf = torch.bfloat16
    res = {
        "grouped": check_grouped("main-bf16", grouped_case(
            rng, dev, B, W, P, D, 1, "bfloat16", bf, NP=NP), timed=True),
        "mode_c": check_partial("ref-mode-c-bf16", "grouped", partial_case(
            rng, dev, B, W, P, D, "bfloat16", bf, NP), 1, timed=True),
        "one_slot": check_one_slot("host-one-slot-bf16", one_slot_case(
            rng, dev, B, W, P, D, "bfloat16", bf, NP), 1, timed=True),
        "dgrid": check_partial("gpt2s-dgrid-bf16", "dgrid", partial_case(
            rng, dev, *gshape, "bfloat16", bf, g["n_pages"]), g["n_heads"],
            timed=True),
        "flat": check_partial("gpt2s-flat-bf16", "flat", partial_case(
            rng, dev, *gshape, "bfloat16", bf, g["n_pages"]), g["n_heads"],
            timed=True),
        "flat_ref": check_partial("ref-flat-bf16", "flat", partial_case(
            rng, dev, B, W, P, D, "bfloat16", bf, NP), 1, timed=True),
    }
    errs = {"paged_decode_attention_grouped": [res["grouped"]["max_abs_err"],
                                               res["mode_c"]["max_abs_err"]],
            "paged_decode_attention": [res["one_slot"]["max_abs_err"]],
            "dgrid_paged_partial": [res["dgrid"]["max_abs_err"]],
            "paged_decode_attention_flat": [res["flat"]["max_abs_err"],
                                            res["flat_ref"]["max_abs_err"]]}
    grouped = errs["paged_decode_attention_grouped"]
    for label, Bn, Wn, Dn, H in (("long-W128", 24, 128, 768, 12),
                                 ("wide-D8192", 32, 4, 8192, 1),
                                 ("odd-dh5", 24, 4, 15, 3)):
        t = one_slot_case(rng, dev, Bn, Wn, P, Dn, "bfloat16", bf,
                          Bn * Wn + 3)
        errs["paged_decode_attention"].append(check_one_slot(
            f"one-slot-{label}-bf16", t, H, timed=False)["max_abs_err"])
        t = grouped_case(rng, dev, Bn, Wn, P, Dn, H, "bfloat16", bf,
                         NP=(Bn + 3) * Wn)
        grouped.append(check_grouped(f"grouped-{label}-bf16", t,
                                     timed=False)["max_abs_err"])
        t = partial_case(rng, dev, Bn, Wn, P, Dn, "bfloat16", bf,
                         (Bn + 2) * Wn)
        t["rs"][6] = Wn * P
        t["lengths"][6] = Wn * P
        grouped.append(check_partial(f"grouped-c-{label}-bf16", "grouped", t,
                                     H, timed=False)["max_abs_err"])
        for kind, name in (("dgrid", "dgrid_paged_partial"),
                           ("flat", "paged_decode_attention_flat")):
            errs[name].append(check_partial(f"{kind}-{label}-bf16", kind, t,
                                            H, timed=False)["max_abs_err"])
    lengths = [0, 1, 4, 8, 9, 12, 16, 17, 20, 24, 25, 31, 32, 33, 36, 40, 47,
               48, 49, 64, 65, 72, 96, 97, 100, 112, 127, 128, 0, 3]
    t = grouped_case(rng, dev, len(lengths), 4, P, D, 1, "bfloat16", bf,
                     NP=(len(lengths) + 3) * 4, lengths=lengths)
    for rep in range(5):
        grouped.append(check_grouped(f"fused-positions-bf16-{rep}", t,
                                     timed=False)["max_abs_err"])
    return res, errs


def as_float32(tree):
    """A parameter tree's dense leaves in float32 (the same values)."""
    return {"wte": tree["wte"].float(), "wpe": tree["wpe"].float(),
            "layers": [{k: v.float() for k, v in layer.items()}
                       for layer in tree["layers"]]}


def bf16_tie(T, params, model, tokens):
    """The near-tie measure of [bf16-kv] (ii) at the token after
    ``tokens``: the top-2 gap of the f32 logits of a plain forward on the
    float32 values of the weights, and the model's precision noise there
    (the largest change of a logit between that forward and the same one
    in the model's dtype, bfloat16). Returns (gap, noise)."""
    from min_llm_inference_tpu_torch.tools.fuzz_draws import plain_logits

    f32 = plain_logits(as_float32(params),
                       dataclasses.replace(model, dtype="float32"), tokens)
    low = plain_logits(params, model, tokens).float()
    top = torch.topk(f32, 2)
    return (float(top.values[0] - top.values[1]),
            float((low - f32).abs().max()))


def bf16_host(T, dev, gpu_line):
    """[bf16-kv] (ii): the host path as ``python bench.py --engine host
    --kv-dtype bfloat16 --rounds 32`` runs the JAX package (PagedEngine,
    the reference model and request stream of phase 5, 32 rounds an
    iteration, bf16 KV) on the fused-write kernel ("grouped", bench.py's
    default), then on the one-slot kernel ("paged"): a warm run of 64
    requests each, then the timed run with the launch counters at 0 (one
    attention launch a round, nothing else). The two must agree token for
    token but for near-ties (bf16_tie: the top-2 gap below NEAR_TIE x the
    model's bf16 noise there), in at most MESH_TP_MAX_DIFFERING requests.
    The middle one-slot call is replayed against the plain version.
    Returns ({impl: launches}, the replayed call's result)."""
    from min_llm_inference_tpu_torch import bench as tbench

    V, D, S, P = (MAIN["n_vocab"], MAIN["emb_dim"], MAIN["n_seq"],
                  MAIN["page_size"])
    n_req = MAIN["requests"]
    model = tbench.ref_model()
    cfg = T.EngineConfig(n_slots=MAIN["n_slots"], n_pages=MAIN["n_pages"],
                         n_forward_rounds=32, page_size=P, init_num_pages=2,
                         kv_dtype="bfloat16", max_prefill_batch=128,
                         decode_ring=False, subbursts=2)
    params = tbench.ref_params(dev)
    kname = {"grouped": "paged_decode_attention_grouped",
             "paged": "paged_decode_attention"}

    def run(impl, n, seed):
        return drive(T, dev, params, model, cfg, n, seed,
                     dict(attention_impl=impl), engine_cls=T.PagedEngine)

    kernels = counters()
    stores, launches = {}, {}
    for impl in ("grouped", "paged"):
        run(impl, 64, seed=1)
        for k in kernels.values():
            k.launches = 0
        eng, store, wall = run(impl, n_req, seed=2)
        PATH_WALLS[f"bf16-kv-host-{impl}"] = wall
        got = {name: k.launches for name, k in kernels.items() if k.launches}
        st = eng.stats
        if got != {kname[impl]: st.rounds * model.n_layers}:
            raise AssertionError(f"bf16-kv host {impl}: launches {got}, "
                                 f"expected {st.rounds} of {kname[impl]}")
        total = check_outputs(store, n_req, S, V)
        stores[impl], launches[impl] = store, st.rounds * model.n_layers
        log("bf16-kv", path="host", attention=impl, requests=n_req,
            generated=total, wall_s=f"{wall:.4f}",
            tok_s=f"{total / wall:.1f}", gpu=f"'{gpu_line}'",
            iterations=st.bursts, rounds=st.rounds, prefills=st.prefills,
            preemptions=st.preemptions, kernel_launches=launches[impl])
    want, got = tokens_of(stores["grouped"]), tokens_of(stores["paged"])
    ratios = []
    for rid in sorted(want):
        if want[rid] == got[rid]:
            continue
        j = next(i for i, (a, b) in enumerate(zip(want[rid], got[rid]))
                 if a != b)
        gap, noise = bf16_tie(T, params, model, want[rid][:j])
        ratios.append(gap / noise if noise > 0 else float("inf"))
        log("bf16-kv-tie", request=rid, token=j,
            tokens=f"{want[rid][j]}->{got[rid][j]}", gap=f"{gap:.4g}",
            bf16_noise=f"{noise:.4g}", gap_over_noise=f"{ratios[-1]:.3f}")
    log("bf16-kv", path="host", tokens="paged vs grouped",
        differing=len(ratios),
        max_gap_over_noise=f"{max(ratios):.3f}" if ratios else "-")
    far = [r for r in ratios if not r < NEAR_TIE]
    if far or len(ratios) > MESH_TP_MAX_DIFFERING:
        raise AssertionError(
            f"bf16-kv host: {len(ratios)} requests differ between the "
            f"one-slot and the fused-write kernel (at most "
            f"{MESH_TP_MAX_DIFFERING}), {len(far)} not at a near-tie")
    n_call = launches["paged"] // 2
    snaps, _ = capture_calls(lambda: run("paged", n_req, seed=2), {
        "one": ("models.paged", "paged_decode_attention", n_call)})
    args, kw = snaps["one"]
    res = check_one_slot(
        f"bf16-kv-host-call-{n_call}",
        dict(zip(("q", "pool", "lengths", "table", "ks", "vs"), args)),
        kw["n_heads"], timed=True)
    return launches, res


def bf16_flagship(T, dev, gpu_line) -> int:
    """[bf16-kv] (iii): the flagship decode step (entry.entry(): 12
    layers, 12 heads, emb 768, bf16 weights and KV, 256 slots, 2048 pages
    of 16) at full width, once on "torch" (the gather oracle, JAX's
    "jnp") and once on "grouped" (the fused-write kernel, one launch a
    layer) over copies of one state. Logits and the written pools must be
    finite; the tokens must agree but for near-ties: a slot that differs
    must have its top-2 gap in the "torch" logits below NEAR_TIE x the
    largest change of any live logit between the two paths, and at most
    MESH_TP_MAX_DIFFERING slots may differ. Returns the kernel's
    launches."""
    import functools

    from min_llm_inference_tpu_torch.entry import entry
    from min_llm_inference_tpu_torch.models import model as mm
    from min_llm_inference_tpu_torch.models.paged import PagedKVState
    from min_llm_inference_tpu_torch.ops.paged_attention_grouped import (
        paged_decode_attention_grouped as grouped)

    t0 = time.perf_counter()
    fn, (params, state, packed, lengths, last) = entry(dev)
    model, engine = fn.args[:2]
    setup_s = time.perf_counter() - t0
    real = mm.greedy_next_token
    out = {}
    for impl in ("torch", "grouped"):
        step = functools.partial(fn.func, model, engine, impl)
        st = PagedKVState(tuple(p.clone() for p in state.kv_pages),
                          state.k_scales, state.v_scales)
        seen = []

        def record(logits, *a, _seen=seen):
            _seen.append(logits.float().clone())
            return real(logits, *a)

        grouped.launches = 0
        mm.greedy_next_token = record
        try:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            new_st, lens, _, toks = step(params, st, packed, lengths, last)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        finally:
            mm.greedy_next_token = real
        if not all(bool(torch.isfinite(p).all()) for p in new_st.kv_pages):
            raise AssertionError(f"bf16-kv flagship {impl}: pool not finite")
        if not bool(torch.isfinite(seen[0]).all()):
            raise AssertionError(f"bf16-kv flagship {impl}: logits not finite")
        out[impl] = (toks.cpu(), lens.cpu(), seen[0], wall, grouped.launches)
    (t_tok, t_len, t_log, t_wall, t_n), (g_tok, g_len, g_log, g_wall, g_n) = (
        out["torch"], out["grouped"])
    want_n = model.n_layers * engine.n_forward_rounds
    if t_n != 0 or g_n != want_n:
        raise AssertionError(f"bf16-kv flagship: grouped launches {t_n} "
                             f"(torch), {g_n} (grouped), expected 0, {want_n}")
    live = packed[:, 0].cpu() > 0
    noise = float((g_log - t_log)[live.to(g_log.device)].abs().max())
    differ = torch.nonzero((t_tok != g_tok).any(dim=1)).flatten().tolist()
    ratios = []
    for b in differ:
        top = torch.topk(t_log[b], 2)
        gap = float(top.values[0] - top.values[1])
        ratios.append(gap / noise if noise > 0 else float("inf"))
        log("bf16-kv-tie", flagship_slot=b,
            tokens=f"{t_tok[b, 0].item()}->{g_tok[b, 0].item()}",
            gap=f"{gap:.4g}", path_noise=f"{noise:.4g}",
            gap_over_noise=f"{ratios[-1]:.3f}")
    agree = (t_tok == g_tok).all(dim=1)
    if not torch.equal(t_len[agree], g_len[agree]):
        raise AssertionError("bf16-kv flagship: lengths differ where the "
                             "tokens agree")
    log("bf16-kv", path="flagship", slots=engine.n_slots,
        layers=model.n_layers, kv_dtype=engine.kv_dtype,
        setup_s=f"{setup_s:.2f}", torch_wall_s=f"{t_wall:.4f}",
        grouped_wall_s=f"{g_wall:.4f}", grouped_launches=g_n,
        tokens="grouped vs torch", differing=len(differ),
        max_logit_change=f"{noise:.4g}",
        max_gap_over_noise=f"{max(ratios):.3f}" if ratios else "-",
        gpu=f"'{gpu_line}'")
    far = [r for r in ratios if not r < NEAR_TIE]
    if far or len(differ) > MESH_TP_MAX_DIFFERING:
        raise AssertionError(
            f"bf16-kv flagship: {len(differ)} slots differ (at most "
            f"{MESH_TP_MAX_DIFFERING}), {len(far)} not at a near-tie")
    return g_n


def bf16_kv_path(T, dev, gpu_line, dot_dir, profile_dir=None) -> dict:
    """[bf16-kv]: bfloat16 KV at full width. (i) the reference path of
    phase 5 with kv_dtype="bfloat16" (4096 pages of 32 rows: a 1.07 GB
    pool): warm run (the capture), timed run (launch counters at 0,
    fused writes = rounds), eager run token-equal to the graph, and its
    middle fused-write call replayed against the plain version; (ii)
    bf16_host; (iii) bf16_flagship. Returns the launches and replayed
    calls of each kernel."""
    t0 = time.perf_counter()
    launches, res, (_, store, wall, _) = main_path(
        T, dev, gpu_line, dot_dir, profile_dir, kv="bfloat16",
        label="bf16-kv")
    host_launches, host_res = bf16_host(T, dev, gpu_line)
    flagship = bf16_flagship(T, dev, gpu_line)
    log("bf16-kv", phase_s=f"{time.perf_counter() - t0:.1f}",
        ref_wall_s=f"{wall:.4f}", requests=len(store.finished))
    return dict(ref_launches=launches, ref=res, host_launches=host_launches,
                host=host_res, flagship_launches=flagship)


def bench_phase(gpu_line) -> None:
    """Phase 15, [bench]: the port's entry points at full width, in this
    process, after every other timed path and before any profiler
    session (graphs captured after one can fault when replayed under a
    later one). ``python -m min_llm_inference_tpu_torch.bench`` on each
    of BENCH_WORKLOADS with BENCH_REPEATS timed runs, all on one engine
    after its warm run: on the graphed engine the timed runs must capture
    nothing. One [bench] line each: bench.py's JSON line, the card, the
    captures, every timed wall, the last timed run's host seconds by
    engine phase, the kernel launches of the whole workload (warm and
    timed runs) and the timed wall of this script's own path for the same
    configuration (PATH_WALLS). Then the serving bench
    closed-loop and open-loop at SERVING_RATE requests/s (every request
    finished), the demo on every backend (every parity line OK) and the
    scaling harness at tp = 1 (one line). Each workload's engine and
    graphs are freed before the next."""
    import contextlib
    import gc
    import io

    from min_llm_inference_tpu_torch import bench as tbench
    from min_llm_inference_tpu_torch.examples import (
        demo_engine,
        scaling_bench,
    )
    from min_llm_inference_tpu_torch.tools import serving_bench

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    kernels = counters()
    for flags, path in BENCH_WORKLOADS:
        args = tbench.parser().parse_args(
            [*flags, "--repeats", str(BENCH_REPEATS)])
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        result, extra = tbench.run(args)
        took = time.perf_counter() - t0
        free()
        graphed = args.engine == "auto"
        S = args.seq
        totals = [r["total_tokens"] for r in extra["runs"]]
        path_wall = PATH_WALLS.get(path)
        log("bench", workload=f"'{' '.join(flags) or '(no flags)'}'",
            gpu=f"'{gpu_line}'", graphed="yes" if graphed else "no",
            warm_captures=extra["warm_captures"],
            timed_captures=extra["timed_captures"],
            walls_s=",".join(f"{r['wall']:.4f}" for r in extra["runs"]),
            tokens=",".join(map(str, totals)),
            path=path or "-",
            path_wall_s=f"{path_wall:.4f}" if path_wall else "-",
            workload_s=f"{took:.1f}",
            last_run_phase_s=",".join(
                f"{n}:{v['seconds']:.4f}"
                for n, v in extra["phase_stats"].items()),
            launches=",".join(f"{n}:{k.launches}" for n, k in
                              kernels.items() if k.launches) or "-",
            line=json.dumps(result))
        if graphed and (extra["timed_captures"] or not extra["warm_captures"]):
            raise AssertionError(
                f"bench {flags}: {extra['warm_captures']} warm and "
                f"{extra['timed_captures']} timed captures (the timed runs "
                "must replay the warm run's graphs)")
        if not all(0 < t <= args.requests * (S - 1) for t in totals):
            raise AssertionError(f"bench {flags}: token totals {totals}")
        if args.model == "gpt2s" and not (
                kernels["prefill_causal_attention"].launches):
            raise AssertionError(f"bench {flags}: the prefill attention "
                                 "kernel never launched")

    for rate in (None, SERVING_RATE):
        argv = [] if rate is None else ["--arrival-rate", str(rate)]
        args = serving_bench.parser().parse_args(argv)
        result, done = serving_bench.serve(args, *serving_bench.resolve(args))
        free()
        n_gen = sum(len(r.tokens) - r.prompt_len for r in done.values())
        log("bench", entry="serving", arrivals=(
            "closed-loop" if rate is None else f"open-loop-{rate}"),
            gpu=f"'{gpu_line}'", requests=len(done),
            line=json.dumps(result))
        if sorted(done) != list(range(args.requests)) or (
                n_gen != result["total_tokens"]):
            raise AssertionError(f"serving {argv}: {len(done)} of "
                                 f"{args.requests} requests finished")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        demo_engine.main(["--backend", "all"])
    free()
    lines = out.getvalue().strip().splitlines()
    for ln in lines:
        log("demo", line=f"'{ln}'")
    parity = [ln for ln in lines if "token parity" in ln]
    if len(parity) != 4 or not all(ln.endswith(": OK") for ln in parity):
        raise AssertionError(f"demo: parity lines {parity}")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        scaling_bench.main(["--tp", "1"])
    lines = out.getvalue().strip().splitlines()
    for ln in lines:
        log("scaling", gpu=f"'{gpu_line}'", line=f"'{ln}'")
    if len(lines) != torch.cuda.device_count().bit_length() or not lines[
            0].startswith("devices= 1 (dp=1 x tp=1)"):
        raise AssertionError(f"scaling: lines {lines}")


def check_trained_kv_rows(params, cfg, eval_tokens, kv) -> None:
    """The fused-write kernel on the trained model's own K/V rows: the
    teacher-forced harness (utils/quality.py, the plain path whose ΔPPL
    [quality] reports) runs over the first max(QUALITY_KV_STEPS) + 2 eval
    tokens at ``kv``; the arguments of its K/V write and attention at each
    of QUALITY_KV_STEPS, last layer, are copied before the write. The
    kernel then writes the same rows into the same pool (its page scales
    updated first, as the engine does) and attends: pool bytes and scales
    must equal the plain quantizer's (_write_kv_tokens), o the gather
    oracle's within 1e-4 x max(1, |o|). One [kernel] line a step."""
    from min_llm_inference_tpu_torch.models.paged import (
        _write_kv_tokens,
        torch_paged_attend,
    )
    from min_llm_inference_tpu_torch.ops.paged_attention_grouped import (
        paged_decode_attention_grouped as kernel,
    )
    from min_llm_inference_tpu_torch.ops.quant import (
        kv_qmax,
        update_page_scales,
    )
    from min_llm_inference_tpu_torch.tools.quality_evidence import (
        eval_engine_config,
    )
    from min_llm_inference_tpu_torch.utils.quality import teacher_forced_nll

    eng = dataclasses.replace(
        eval_engine_config(eval_tokens.shape[0], cfg.n_seq), kv_dtype=kv)
    toks = np.ascontiguousarray(eval_tokens[:, :max(QUALITY_KV_STEPS) + 2])
    lengths = np.full(toks.shape[0], toks.shape[1], np.int32)
    layer = cfg.n_layers - 1
    targets = {}
    for step in QUALITY_KV_STEPS:
        ix = step * cfg.n_layers + layer
        targets[f"write-{step}"] = ("utils.quality", "_write_kv_tokens", ix)
        targets[f"attend-{step}"] = ("utils.quality", "torch_paged_attend",
                                     ix)
    snaps, _ = capture_calls(
        lambda: teacher_forced_nll(params, cfg, eng, toks, lengths), targets)
    packed = kv == "int4"
    for step in QUALITY_KV_STEPS:
        (pool, ks, vs, flat_idx, k, v, fresh), _ = snaps[f"write-{step}"]
        (written, _, _, q, ctx_len, table, P, H), _ = snaps[f"attend-{step}"]
        pool_p, ks_p, vs_p = pool.clone(), ks.clone(), vs.clone()
        _write_kv_tokens(pool_p, ks_p, vs_p, flat_idx, k, v, fresh,
                         n_heads=H)
        o_p = torch_paged_attend(pool_p, ks_p, vs_p, q, ctx_len, table, P, H)
        pool_k, ks_k, vs_k = pool.clone(), ks.clone(), vs.clone()
        update_page_scales(ks_k, k, fresh, kv_qmax(packed))
        update_page_scales(vs_k, v, fresh, kv_qmax(packed))
        o_k, _ = kernel(q, pool_k, ctx_len, table, ks_k, vs_k, k, v,
                        n_heads=H, packed_int4=packed)
        torch.cuda.synchronize()
        name = f"quality-trained-{kv}-step{step}-layer{layer}"
        if not torch.equal(pool_p, written):
            raise AssertionError(f"{name}: the replayed plain write differs "
                                 "from the harness's")
        if not (torch.equal(pool_k, pool_p) and torch.equal(ks_k, ks_p)
                and torch.equal(vs_k, vs_p)):
            bad = (pool_k != pool_p).nonzero()[:5].tolist()
            raise AssertionError(f"{name}: pool bytes or scales differ "
                                 f"(pool at {bad})")
        err = (o_k - o_p).abs().max().item()
        lim = 1e-4 * max(1.0, o_p.abs().max().item())
        if not err <= lim:
            raise AssertionError(f"{name}: max |o_kernel - o_plain| {err} "
                                 f"> {lim}")
        log("kernel", case=name, pool_bytes="identical",
            scales="identical", max_abs_err=f"{err:.6g}",
            slots=q.shape[0], context=step + 1,
            fresh_pages=int((fresh < ks.shape[0]).sum().item()),
            k_absmax=f"{k.abs().max().item():.6g}",
            v_absmax=f"{v.abs().max().item():.6g}")


def train_step_flops(cfg, batch) -> float:
    """Float operations of one training step of the quality tool: the
    forward's matmuls over batch x (n_seq - 1) tokens (q, k, v, o and the
    FFN per layer; q.K and p.V over every one of the S x S scores, as
    dense_causal_logits computes them; the tied logits), times 3 for the
    forward and the backward."""
    S, D = cfg.n_seq - 1, cfg.emb_dim
    per_token = (cfg.n_layers * (2 * 4 * D * D + 2 * 2 * D * cfg.ffn_dim
                                 + 2 * 2 * S * D)
                 + 2 * D * cfg.n_vocab)
    return 3.0 * batch * S * per_token


def quality_phase(gpu_line) -> None:
    """Phase 16, [quality]: the quantization-quality evidence at full size
    (``python -m min_llm_inference_tpu_torch.tools.quality_evidence``):
    the 8L/512D model trained QUALITY_STEPS steps of 64 sequences on the
    card, its perplexity at float32, int8 and int4 KV and at int8 weights
    with int8 KV on 840 x 127 predicted tokens, and the 12L/768D GPT-2
    import smoke; its artifact goes to chiprun_out/quality_torch.json
    beside this script. One [quality] line; then the fused-write kernel on
    the trained model's K/V rows at int8 and int4 (check_trained_kv_rows).
    A missed bound of the tool (ppl_ref < 15, |int8 ΔPPL| <= 0.1, a finite
    GPT-2 smoke) raises."""
    import gc

    from min_llm_inference_tpu_torch.tools import quality_evidence as qe

    t0 = time.perf_counter()
    results, (cfg, params, eval_tokens) = qe.collect(QUALITY_STEPS, "cuda")
    took = time.perf_counter() - t0
    out = os.path.join(HERE, "chiprun_out", "quality_torch.json")
    qe.write_artifact(results, out)
    tr, smoke = results["trained_8l512d"], results["gpt2_import_smoke"]
    step_ms = tr["train_seconds"] / tr["train_steps"] * 1e3
    # a step reads the params and AdamW's two moments and writes all three
    n_params = sum(t.numel() for t in (
        params["wte"], params["wpe"],
        *(w for layer in params["layers"] for w in layer.values())))
    bound_ms, bound_by = bound_of(6 * 4 * n_params,
                                  train_step_flops(cfg, tr["train_batch"]))
    log("quality", gpu=f"'{gpu_line}'", steps=tr["train_steps"],
        batch=tr["train_batch"], loss_first=tr["loss_first"],
        loss_last=tr["loss_last"], train_s=tr["train_seconds"],
        step_ms=step_ms, step_bound_ms=bound_ms, step_bound_by=bound_by,
        precision=f"'{tr['train_precision']}'",
        eval_tokens=tr["eval_predicted_tokens"], eval_s=tr["eval_seconds"],
        ppl_ref=tr["ppl_ref"], int8_kv_dppl=tr["int8_kv"]["delta_ppl"],
        int4_kv_dppl=tr["int4_kv"]["delta_ppl"],
        int8_w_int8_kv_dppl=tr["int8_weights_plus_int8_kv"]["delta_ppl"],
        floor_ppl=tr["corpus_entropy_floor_ppl"],
        gpt2_ppl_ref=smoke["ppl_ref"], gpt2_dppl=smoke["delta_ppl"],
        gpt2_s=smoke["seconds"], phase_s=f"{took:.1f}",
        passed=results["pass"], artifact=os.path.relpath(out, HERE))
    for kv in ("int8", "int4"):
        check_trained_kv_rows(params, cfg, eval_tokens, kv)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if not results["pass"]:
        raise AssertionError(f"quality: {results['pass_criteria']} missed")


# ---------------------------------------------------------------- main


JAX_OPS = "min_llm_inference_tpu/ops"
SOURCES = {
    "paged_decode_attention_grouped": (
        "paged_attention_grouped.cu", f"{JAX_OPS}/paged_attention_grouped.py:645"),
    "dgrid_paged_partial": (
        "paged_attention_dgrid.cu", f"{JAX_OPS}/paged_attention_dgrid.py:195"),
    "ring_flush": ("ring_flush.cu", f"{JAX_OPS}/ring_flush.py:131"),
    "prefill_quant_scatter": ("prefill_scatter.cu",
                              f"{JAX_OPS}/prefill_scatter.py:93"),
    "paged_decode_attention": ("paged_attention.cu",
                               f"{JAX_OPS}/paged_attention.py:250"),
    "paged_decode_attention_flat": (
        "paged_attention_flat.cu", f"{JAX_OPS}/paged_attention_flat.py:337"),
    "int4_page_self_dot": ("int4_probe.cu", "tools/int4_probe.py:25"),
    # no Pallas kernel: the JAX package samples with XLA
    "sample_next_token": ("sample_next_token.cu",
                          f"{JAX_OPS}/reference.py:170"),
    # no Pallas kernel: the JAX package's prefill attention is XLA
    "prefill_causal_attention": (
        "prefill_attention.cu",
        "min_llm_inference_tpu/models/model.py:194"),
    "mla_decode_attention": ("mla_decode.cu",
                             "none: the JAX package has no latent attention"),
}


def split_means(split, shape) -> dict:
    """The mean device_ev_ms of each timing variant of one [split] shape,
    as JSON keys."""
    key = shape.replace("-", "_")
    return {f"split_{key}_{v}_ms": float(np.mean(ms))
            for v, ms in split[shape].items()}


def kernel_entry(name, launches, errs, res, **extra):
    """One kernel's entry of the JSON line; ``name`` may carry a pool kind
    (``paged_decode_attention_grouped[bf16]``), a row of its own."""
    src, tpu = SOURCES[name.split("[")[0]]
    return {"name": name, "route": "cuda",
            "source": f"min_llm_inference_tpu_torch/csrc/{src}",
            "replaces": tpu, "launches": launches, "max_abs_err": max(errs),
            "ms": res["ms"], "device_ms": res.get("device_ms"),
            "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": res.get("library_ms"), **extra}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="also profile one run of each full-width path "
                         "into DIR, once every path has run")
    ap.add_argument("--only",
                    choices=["mesh-tp", "bf16-kv", "bench", "quality",
                             "prefill-attn", "deepseek"],
                    default=None,
                    help="build the kernels and run this stage alone "
                         "(no kernels line, no last line)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import min_llm_inference_tpu_torch as T
    from min_llm_inference_tpu_torch.ops import _build
    from min_llm_inference_tpu_torch.ops import sampling as tsamp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(gpu_line, flush=True)
    global INT32_OPS_PER_S
    INT32_OPS_PER_S = int32_ops_per_s()
    log("device", name=f"'{torch.cuda.get_device_name(0)}'",
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, tf32="off",
        int32_ops_per_s=f"{INT32_OPS_PER_S:.6g}")

    if args.only == "mesh-tp":
        _build.build(_build.SOURCES + _build.HOST_SOURCES)
        mesh_tp_only(T, dev, gpu_line)
        return 0
    if args.only == "bench":
        _build.build(_build.SOURCES + _build.HOST_SOURCES)
        bench_phase(gpu_line)
        return 0
    if args.only == "quality":
        _build.build(_build.SOURCES + _build.HOST_SOURCES)
        quality_phase(gpu_line)
        return 0
    if args.only == "prefill-attn":
        _build.build(("prefill_attention.cu",))
        prefill_attn_phase(dev)
        device_times()
        return 0
    if args.only == "deepseek":
        _build.build(("mla_decode.cu", "prefill_attention.cu",
                      "graph_cond.cu"))
        entries, pf192 = deepseek_phase(T, dev, gpu_line)
        print(json.dumps({"deepseek_kernels": entries, "prefill_192_128":
                          pf192}), flush=True)
        return 0
    if args.only == "bf16-kv":
        _build.build(_build.SOURCES + _build.HOST_SOURCES)
        dot_dir = tempfile.mkdtemp(prefix="burst-graphs-")
        bf16_kv_path(T, dev, gpu_line, dot_dir)
        shutil.rmtree(dot_dir)
        return 0

    t0 = time.perf_counter()
    items = _build.SOURCES + _build.HOST_SOURCES + tuple(
        (src, defs) for src in SPLIT_SOURCES
        for defs in SPLIT_VARIANTS.values() if defs)
    took = _build.build(items)
    for item in items:
        src, defs = _build.build_item(item)
        with open(_build.library_path(src, defs) + ".log") as f:
            ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
        log("build", source=src, defines=",".join(defs) or "-",
            nvcc_s=f"{took.get(item, 0.0):.2f}",
            ptxas=f"'{' | '.join(ptxas[:4])}'")
    log("build", total_s=f"{time.perf_counter() - t0:.2f}")

    # DeepSeek-V2-Lite first, while nothing else holds the card's memory
    # (its weights and pool take 64 GB of the 80)
    ds_entries, ds_prefill = deepseek_phase(T, dev, gpu_line)

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
    errs = {k: [] for k in SOURCES}
    errs["paged_decode_attention_grouped"] += [main4["max_abs_err"],
                                               main8["max_abs_err"]]
    for kv in ("int4", "int8", "float32"):
        for in_dtype in (torch.float32, torch.bfloat16):
            r = check_grouped(f"small-H2-{kv}-{str(in_dtype)[6:]}",
                              grouped_case(rng, dev, 8, 2, 16, 32, 2, kv,
                                           in_dtype), timed=False)
            errs["paged_decode_attention_grouped"].append(r["max_abs_err"])
    r = check_grouped("odd-dh-int4", grouped_case(
        rng, dev, 5, 3, 8, 36, 3, "int4", torch.float32), timed=False)
    errs["paged_decode_attention_grouped"].append(r["max_abs_err"])

    # the gpt2s path's shapes: 1024 slots, W = 4 pages of 32 rows, 4096
    # pages, emb 768 in 12 heads, int8 pages, bf16 projections
    g = GPT2S
    gW = -(-g["n_seq"] // g["page_size"])
    gshape = (g["n_slots"], gW, g["page_size"], g["emb_dim"])
    mode_c = {}
    for kv in ("int8", "int4"):
        mode_c[kv] = check_partial(
            f"gpt2s-mode-c-{kv}", "grouped",
            partial_case(rng, dev, *gshape, kv, torch.bfloat16, g["n_pages"]),
            g["n_heads"], timed=True)
        errs["paged_decode_attention_grouped"].append(
            mode_c[kv]["max_abs_err"])
    dgrid_rand = check_partial(
        "gpt2s-dgrid-int8", "dgrid",
        partial_case(rng, dev, *gshape, "int8", torch.bfloat16, g["n_pages"]),
        g["n_heads"], timed=True)
    errs["dgrid_paged_partial"].append(dgrid_rand["max_abs_err"])
    for kind, kvs in (("grouped", ("float32", "int8", "int4")),
                      ("dgrid", ("float32", "int8"))):
        for kv in kvs:
            for H, D in ((1, 32), (2, 32), (12, 96)):
                r = check_partial(
                    f"small-{kind}-H{H}-{kv}", kind,
                    partial_case(rng, dev, 16, 4, 8, D, kv, torch.float32,
                                 18 * 4), H, timed=False)
                errs["paged_decode_attention_grouped" if kind == "grouped"
                     else "dgrid_paged_partial"].append(r["max_abs_err"])
    flush_rand = check_flush("gpt2s-flush-int8", flush_case(
        rng, dev, g["n_slots"], gW, g["page_size"], g["emb_dim"],
        g["n_pages"], 16), timed=True)
    for dtype, Dk in ((torch.float32, 24), (torch.bfloat16, 20),
                      (torch.int8, 7)):
        t = flush_case(rng, dev, 13, 3, 8, Dk, 16 * 3, 6, dtype)
        t["r0"] = torch.from_numpy(
            rng.integers(0, 6, 13).astype(np.int32)).to(dev)
        check_flush(f"small-flush-{str(dtype)[6:]}-r0", t, timed=False)
    # the largest prefill bucket: max_new_per_burst rows of 64-token prompts
    prefill_rand = check_prefill("gpt2s-prefill-bf16", prefill_case(
        rng, dev, min(512, g["n_slots"]), 64, g["emb_dim"], g["page_size"],
        gW, g["n_pages"]), timed=True)
    check_prefill("small-prefill-f32-odd", prefill_case(
        rng, dev, 9, 16, 36, 8, 4, 64, torch.float32), timed=False)
    # the host path's prefill blocks: max_prefill_batch rows of n_seq
    # tokens at emb 2048
    prefill_host = check_prefill("host-prefill-bf16", prefill_case(
        rng, dev, 128, MAIN["n_seq"], MAIN["emb_dim"], P,
        shape[1], MAIN["n_pages"]), timed=True)
    # the causal prefill attention at the gpt2-small cells' blocks
    prefill_attn = prefill_attn_phase(dev)
    errs["prefill_causal_attention"] += [r["max_rel_err"]
                                         for r in prefill_attn.values()]
    # the host path's one-slot calls: 1024 slots, W = 4 pages of 32 rows,
    # emb 2048, one head, int8 pages, a fragmented table
    one_rand = check_one_slot("host-one-slot-int8", one_slot_case(
        rng, dev, MAIN["n_slots"], shape[1], P, MAIN["emb_dim"], "int8",
        torch.bfloat16, MAIN["n_pages"]), 1, timed=True)
    errs["paged_decode_attention"] = [one_rand["max_abs_err"]]
    for H, D in ((2, 64), (12, 96)):
        r = check_one_slot(f"small-one-slot-H{H}-f32", one_slot_case(
            rng, dev, 16, 4, 8, D, "float32", torch.float32, 16 * 4 + 3,
            boundary=True), H, timed=False)
        errs["paged_decode_attention"].append(r["max_abs_err"])
    # the flat ring partial at the gpt2s path's shapes (int8, 12 heads),
    # at the reference ring's (1024 slots, packed int4, emb 2048, one
    # head), and small: full groups and overcommit's half-group rows
    flat_rand = {
        "gpt2s": check_partial(
            "gpt2s-flat-int8", "flat", partial_case(
                rng, dev, *gshape, "int8", torch.bfloat16, g["n_pages"]),
            g["n_heads"], timed=True),
        "ref": check_partial(
            "ref-flat-int4", "flat", partial_case(
                rng, dev, *shape[:4], "int4", torch.bfloat16,
                MAIN["n_pages"]), 1, timed=True)}
    errs["paged_decode_attention_flat"] += [
        r["max_abs_err"] for r in flat_rand.values()]
    for kv in ("float32", "int8", "int4"):
        for H, D in ((1, 32), (2, 32), (12, 96)):
            for table, make in (("groups", partial_case),
                                ("half", half_group_case)):
                r = check_partial(
                    f"small-flat-H{H}-{kv}-{table}", "flat",
                    make(rng, dev, 16, 4, 8, D, kv, torch.float32, 18 * 4),
                    H, timed=False)
                errs["paged_decode_attention_flat"].append(r["max_abs_err"])
    partial_edges(rng, dev, errs)
    attention_edges(rng, dev, errs)
    # bfloat16 pools, from a generator of their own (the later phases'
    # random inputs stay as they were)
    bf16_rand, bf16_errs = bf16_checks(np.random.default_rng(11), dev)
    split = split_times(rng, dev)
    probe_launches, probe_res = check_probe(dev)
    errs["int4_page_self_dot"].append(probe_res["max_abs_err"])
    sample_rand = sample_checks(rng, dev)
    sample_edge = sample_edges(rng, dev)
    errs["sample_next_token"] += [r["max_abs_err"]
                                  for r in (*sample_rand, *sample_edge)]
    switch = sample_switch(rng, dev)

    mode_c_engine, bf16_engine = engine_parity(T, dev)
    flat_engine = variant_parity(T, dev)
    one_slot_engine, bf16_host_engine = host_parity(T, dev)
    # ms, plain_ms and bound_ms: one call of each path replayed on its real
    # inputs; launches: each path's timed run
    dot_dir = tempfile.mkdtemp(prefix="burst-graphs-")
    ref_launches, ref, (ref_eng, ref_store, ref_wall, ref_warm) = main_path(
        T, dev, gpu_line, dot_dir, args.profile)
    errs["paged_decode_attention_grouped"].append(ref["max_abs_err"])
    g_launches, g_res = gpt2s_path(T, dev, gpu_line, dot_dir, args.profile)
    for name, r in g_res.items():
        errs[name].append(r["max_abs_err"])
    h_launches, h_res = host_path(T, dev, gpu_line, args.profile)
    for name, r in h_res.items():
        errs[name].append(r["max_abs_err"])
    f_launches, f_res = flat_path(T, dev, gpu_line, dot_dir, args.profile)
    for name, r in f_res.items():
        errs[name].append(r["max_abs_err"])
    o_launches, o_res, preemptions = overcommit_path(T, dev, gpu_line,
                                                     dot_dir, args.profile)
    stream_path(T, gpu_line, ref_eng, ref_store)
    s_launches, s_res = main_sample_path(T, dev, gpu_line, dot_dir,
                                         (ref_wall, ref_warm), args.profile)
    errs["sample_next_token"] += [r["max_abs_err"] for r in s_res.values()]
    weights_path(T, dev, gpu_line, dot_dir, ref_wall, args.profile)
    bf16 = bf16_kv_path(T, dev, gpu_line, dot_dir, args.profile)
    bf16_errs["paged_decode_attention_grouped"].append(
        bf16["ref"]["max_abs_err"])
    bf16_errs["paged_decode_attention"].append(bf16["host"]["max_abs_err"])
    bench_phase(gpu_line)
    quality_phase(gpu_line)
    for run, wall, label in PROFILE_PENDING:
        profile_path(run, args.profile, wall, label)
    PROFILE_PENDING.clear()
    shutil.rmtree(dot_dir)
    errs["paged_decode_attention_grouped"].append(o_res["max_abs_err"])
    device_times()
    mesh_launches = mesh_stage(T, dev, gpu_line, ref_store)

    entries = [kernel_entry(
        "paged_decode_attention_grouped", ref_launches,
        errs["paged_decode_attention_grouped"], ref,
        mean_live_len=ref["mean_live_len"], live_slots=ref["live_slots"],
        run_bound_ms_per_launch=ref["run_bound_ms_per_launch"],
        random_int4_ms=main4["ms"], random_int4_bound_ms=main4["bound_ms"],
        random_int8_ms=main8["ms"], random_int8_bound_ms=main8["bound_ms"],
        mode_c_gpt2s_int8_ms=mode_c["int8"]["ms"],
        mode_c_gpt2s_int8_plain_ms=mode_c["int8"]["plain_ms"],
        mode_c_gpt2s_int8_bound_ms=mode_c["int8"]["bound_ms"],
        mode_c_gpt2s_int4_ms=mode_c["int4"]["ms"],
        mode_c_gpt2s_int4_plain_ms=mode_c["int4"]["plain_ms"],
        mode_c_gpt2s_int4_bound_ms=mode_c["int4"]["bound_ms"],
        mode_c_engine_parity_launches=mode_c_engine,
        overcommit_launches=o_launches["paged_decode_attention_grouped"],
        overcommit_preemptions=preemptions, overcommit_ms=o_res["ms"],
        overcommit_plain_ms=o_res["plain_ms"],
        overcommit_bound_ms=o_res["bound_ms"],
        overcommit_device_ms=o_res["device_ms"],
        **split_means(split, "fused-int4"),
        **split_means(split, "fused-int8"))]
    rand = {"dgrid_paged_partial": dgrid_rand, "ring_flush": flush_rand,
            "prefill_quant_scatter": prefill_rand}
    for name in ("dgrid_paged_partial", "ring_flush", "prefill_quant_scatter"):
        extra = {}
        if name == "prefill_quant_scatter":
            hp = h_res[name]
            extra = dict(host_launches=h_launches[name], host_ms=hp["ms"],
                         host_plain_ms=hp["plain_ms"],
                         host_bound_ms=hp["bound_ms"],
                         random_128x128x2048_ms=prefill_host["ms"],
                         random_128x128x2048_plain_ms=prefill_host["plain_ms"],
                         random_128x128x2048_bound_ms=prefill_host["bound_ms"],
                         overcommit_launches=o_launches[name])
        if name == "ring_flush":
            fp = f_res[name]
            extra = dict(flat_launches=f_launches[name], flat_ms=fp["ms"],
                         flat_plain_ms=fp["plain_ms"],
                         flat_bound_ms=fp["bound_ms"])
        entries.append(kernel_entry(
            name, g_launches[name], errs[name], g_res[name],
            random_ms=rand[name]["ms"],
            random_device_ms=rand[name]["device_ms"],
            random_bound_ms=rand[name]["bound_ms"],
            random_plain_ms=rand[name]["plain_ms"], **extra))
    hr = h_res["paged_decode_attention"]
    entries.append(kernel_entry(
        "paged_decode_attention", h_launches["paged_decode_attention"],
        errs["paged_decode_attention"], hr,
        mean_live_len=hr["mean_live_len"], live_slots=hr["live_slots"],
        run_bound_ms_per_launch=hr["run_bound_ms_per_launch"],
        random_ms=one_rand["ms"], random_plain_ms=one_rand["plain_ms"],
        random_bound_ms=one_rand["bound_ms"],
        engine_parity_launches=one_slot_engine,
        device_ev_ms_mid=hr["device_ev_ms_mid"],
        device_ev_ms_end=hr["device_ev_ms"],
        **split_means(split, "one-slot-int8")))
    fr = f_res["paged_decode_attention_flat"]
    entries.append(kernel_entry(
        "paged_decode_attention_flat", f_launches["paged_decode_attention_flat"],
        errs["paged_decode_attention_flat"], fr,
        live_slots=fr["live_slots"],
        mean_live_ring_start=fr["mean_live_ring_start"],
        **{f"random_{k}_{n}": flat_rand[k][n] for k in flat_rand
           for n in ("ms", "device_ms", "plain_ms", "bound_ms")},
        engine_parity_launches=flat_engine))
    entries.append(kernel_entry(
        "int4_page_self_dot", probe_launches, errs["int4_page_self_dot"],
        probe_res,
        yardstick_device_ms=probe_res["yardstick"]["device_ms"],
        yardstick_device_ev_ms=probe_res["yardstick"]["device_ev_ms"],
        library_device_ms=probe_res["library_device"]["device_ms"],
        library_device_ev_ms=probe_res["library_device"]["device_ev_ms"]))
    sr = s_res["ref"]
    entries.append(kernel_entry(
        "sample_next_token", s_launches["sample_next_token"],
        errs["sample_next_token"], sr,
        near_ties=sum(r["near_ties"] for r in (*sample_rand, *sample_edge,
                                               *s_res.values())),
        live_rows=sr["live_rows"], drawn=sr["drawn"],
        bound_bytes_ms=sr["bound_bytes_ms"], bound_ops_ms=sr["bound_ops_ms"],
        bound_ops_f32_ms=sr["bound_ops_f32_ms"],
        int32_ops_per_s=INT32_OPS_PER_S, narrow_max_v=tsamp.narrow_max_v(),
        edge_checks=len(sample_edge),
        edge_rows_whole_row_select=sum(r["select_whole_row"]
                                       for r in sample_edge),
        **switch,
        **{f"gpt2_vocab_{k}": s_res["gpt2"][k]
           for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                     "bound_bytes_ms", "bound_ops_ms", "bound_ops_f32_ms",
                     "drawn")},
        **{f"random_V{r_V}_T{T_}_k{k_}_{n}": r[n]
           for (r_V, (T_, k_)), r in zip(
               [(V_, st_) for V_ in (MAIN["n_vocab"], GPT2_VOCAB)
                for st_ in SAMPLE_SETTINGS], sample_rand)
           for n in ("ms", "device_ms", "plain_ms", "bound_ms")}))
    pl, pr_ = prefill_attn["long-prompt"], prefill_attn["reasoning"]
    entries.append(kernel_entry(
        "prefill_causal_attention", g_launches["prefill_causal_attention"],
        errs["prefill_causal_attention"], pl, launches_on="gpt2s",
        max_err_of="each (row, head)'s largest |out|",
        bf16_max_ulps=max(r["bf16_max_ulps"] for r in prefill_attn.values()),
        device_ev_ms=pl["device_ev_ms"], bound_bytes_ms=pl["bound_bytes_ms"],
        bound_ops_ms=pl["bound_ops_ms"],
        **{f"reasoning_{n}": pr_[n] for n in (
            "ms", "device_ms", "device_ev_ms", "plain_ms", "bound_ms",
            "library_ms")}, **ds_prefill))
    entries += ds_entries
    # the four attention kernels at bfloat16 pools: launches on [bf16-kv]
    # (the grouped kernel in (i), the one-slot kernel in (ii)); dgrid and
    # flat run on no full-width bf16 path, so theirs are phase 4's
    br = bf16_rand
    entries += [
        kernel_entry(
            "paged_decode_attention_grouped[bf16]", bf16["ref_launches"],
            bf16_errs["paged_decode_attention_grouped"], bf16["ref"],
            launches_on="bf16-kv (i)",
            run_bound_ms_per_launch=bf16["ref"]["run_bound_ms_per_launch"],
            host_grouped_launches=bf16["host_launches"]["grouped"],
            flagship_launches=bf16["flagship_launches"],
            engine_parity_launches=bf16_engine[
                "paged_decode_attention_grouped"]
            + bf16_host_engine["paged_decode_attention_grouped"],
            **{f"random_{k}_{n}": br[k][n] for k in ("grouped", "mode_c")
               for n in ("ms", "plain_ms", "bound_ms")}),
        kernel_entry(
            "paged_decode_attention[bf16]", bf16["host_launches"]["paged"],
            bf16_errs["paged_decode_attention"], bf16["host"],
            launches_on="bf16-kv (ii)",
            engine_parity_launches=bf16_host_engine["paged_decode_attention"],
            **{f"random_{n}": br["one_slot"][n]
               for n in ("ms", "plain_ms", "bound_ms")}),
        kernel_entry(
            "dgrid_paged_partial[bf16]", bf16_engine["dgrid_paged_partial"],
            bf16_errs["dgrid_paged_partial"], br["dgrid"],
            launches_on="phase 4 engine parity (no full-width bf16 path)"),
        kernel_entry(
            "paged_decode_attention_flat[bf16]",
            bf16_engine["paged_decode_attention_flat"],
            bf16_errs["paged_decode_attention_flat"], br["flat"],
            launches_on="phase 4 engine parity (no full-width bf16 path)",
            **{f"random_ref_{n}": br["flat_ref"][n]
               for n in ("ms", "plain_ms", "bound_ms")})]
    for e in entries:  # each kernel's launches over every mesh run
        e["mesh_launches"] = mesh_launches.get(e["name"], 0)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
