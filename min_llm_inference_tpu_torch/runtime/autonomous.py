"""Device-resident continuous batching: the scheduler runs on the device.

Counterpart of min_llm_inference_tpu/runtime/autonomous.py. The request
queue (padded prompts + lengths) is uploaded once; each burst frees dead
slots' pages (vectorized stack push), admits queue-head requests into dead
slots (vectorized stack pop), prefills them, runs n_forward_rounds of
decode (greedy or sampled) and scatters the tokens into a device-resident
output buffer. The host reads a 5-int status once per chunk of bursts and
the outputs once at the end.

Admission policy (``EngineConfig.overcommit``):
  * full grant (default): a slot gets one contiguous W-page group at
    admission, no growth or preemption;
  * overcommit: half-group grants (W/2 contiguous pages), growth before a
    slot crosses into its second half (a lookahead of the sub-burst's
    rounds), youngest-first preemption when the pool runs dry, and a
    device retry stack (LIFO) that re-admits preempted requests before the
    queue head. Greedy decode makes recompute after preemption invisible
    in the outputs. A device-side count of preemptions rides out with the
    final output read.

Ring decode (``decode_ring`` on the ``grouped`` path): each round's K/V
rows go to a per-layer ring instead of the pool; the pool is read-only
during the rounds and the ring is flushed into the pages once per
sub-burst, or once per burst when ``burst_flush`` carries one ring across
``subbursts > 1`` (ring columns then index the absolute round and
``ring_r0`` marks each admittee's first column). The page partial comes
from dgrid, the dense view, the flat kernel or the grouped kernel's mode
(c) (models/paged.make_ring_round_callbacks). ``sort_admits`` orders each
full-grant admitted wave by prompt length before slots and groups are
assigned.

Nothing in a burst reads a device value to the host. The whole-burst
liveness gate (JAX: ``lax.cond``) and the prefill bucket each sub-burst
picks from its admitted count (JAX: ``lax.switch``) stay on the device
(runtime/graph.py), and so do the counts of skipped bursts, rounds and
prefill blocks, which ride the run's final output pull with the preemption
count. On CUDA a burst is one CUDA graph, the gate and the bucket its IF
nodes; a chunk replays it ``bursts_per_chunk`` times and reads the 5-int
status once. ``BurstStats.host_syncs`` counts every sync of a run: the two
input uploads, one status read per chunk and the final pull.

Sampling (``temperature > 0``, optional ``top_k``): the state carries a
threefry key (ops/random, JAX's own bits); every executed round splits it
and draws its tokens (ops/sampling: on CUDA one kernel launch that does
the split too, inside the graph), as the JAX burst's scan does. A burst
the gate skips draws nothing, and the key rides across sub-bursts, chunks
and drain widths, so the tokens are JAX's for the same seed.

Latent attention (a ``DeepSeekV2Config``, whose ``is_mla`` chooses it): the
same admission, page groups, prefill bucket, drain downshift and gate over
a latent pool (models/paged.py), with DeepSeek-V2's prefill and decode
round (models/deepseek_v2.py) in the burst; its expert layers add their
rows and their largest expert's rows to ``BurstStats``.

StreamingSession serves on the same burst: submit, step, dispatch/observe,
poll and close, with rows recycled mod capacity.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
from typing import List, NamedTuple

import numpy as np
import torch

from ..config import EngineConfig, ModelConfig, resolve_device
from ..metrics import get_global_throughput_counter
from ..models import deepseek_v2
from ..models.model import DEFAULT_CTX, decode_round_tokens, prefill_write_kv
from ..models.paged import (
    PagedKVState,
    init_paged_state,
    make_latent_prefill_writer,
    make_latent_round_callbacks,
    make_prefill_kv_writer,
    make_ring_round_callbacks,
    make_round_kv_callbacks,
    pack_ring_for_flush,
    ring_pad_rows,
    scale_reduce_of,
)
from ..models.params import fuse_qkv_params, params_device
from ..ops import _build
from ..ops.indexing import index_set_drop_
from ..ops.random import prng_key
from ..ops.ring_flush import ring_flush
from ..ops.sampling import sample_next_token
from ..utils import profiling
from ..utils.profiling import phase
from .graph import (
    capture,
    capture_stream,
    count_dot_nodes,
    device_if,
    device_switch,
    new_pools,
    warming,
)
from .item_storage import ItemStorage, Request

I32 = torch.int32


class AutoState(NamedTuple):
    kv: PagedKVState
    page_table: torch.Tensor   # [B, W] i32
    lengths: torch.Tensor      # [B] i32 (0 = dead)
    last_tokens: torch.Tensor  # [B] i32
    rid: torch.Tensor          # [B] i32 request index per slot
    allocated: torch.Tensor    # [B] bool, slot holds pages (needs freeing)
    queue_head: torch.Tensor   # [] i32
    free_top: torch.Tensor     # [] i32, page_stack[0:free_top] are free units
    page_stack: torch.Tensor   # [NP // unit] i32 free-list of unit ids (a
                               # unit: W pages, or W/2 under overcommit)
    out_tokens: torch.Tensor   # [R_total, S] i32 generated tokens by position
    final_lens: torch.Tensor   # [R_total] i32 (0 = unfinished)
    rng_key: torch.Tensor | None = None      # [2] i64 (sampling only)
    # --- overcommit only (None under full grant) ---
    grown: torch.Tensor | None = None        # [B] bool, slot holds 2 halves
    adm_seq: torch.Tensor | None = None      # [B] i32 admission order
    seq_ctr: torch.Tensor | None = None      # [] i32
    retry_stack: torch.Tensor | None = None  # [R_total] i32 preempted rids
    retry_top: torch.Tensor | None = None    # [] i32
    preempted: torch.Tensor | None = None    # [] i32 preemptions so far


@dataclasses.dataclass
class BurstStats:
    """What the engine did: bursts dispatched, bursts the liveness gate
    skipped, decode rounds executed, prefill blocks run (one per sub-burst
    that admitted), slot-rounds executed (each executed burst's width x
    its rounds; these four counted on the device and read with the final
    outputs), host syncs (the host waiting on the device: the run's two
    input uploads, status and output reads, and with tracing on the read
    of the device phase table), under overcommit preemptions (read with
    the final outputs), and on CUDA the graphs captured (one per executed
    width at a queue shape's first run; a capture makes no host sync).
    A model with routed experts adds, over its expert-layer calls (prefill
    and decode), the rows routed (``expert_rows``: tokens x experts a
    token) and the rows of each call's busiest expert
    (``expert_rows_max``), counted on the device from the dispatch's
    offsets."""

    bursts: int = 0
    skipped: int = 0
    rounds: int = 0
    prefills: int = 0
    slot_rounds: int = 0
    expert_rows: int = 0
    expert_rows_max: int = 0
    host_syncs: int = 0
    preemptions: int = 0
    captures: int = 0


def _check_supported(model_cfg: ModelConfig, attention_impl: str,
                     tp: int) -> None:
    if attention_impl not in ("grouped", "torch"):
        raise ValueError(f"unknown attention_impl {attention_impl!r}")
    if model_cfg.is_mla and attention_impl != "grouped":
        raise ValueError("a latent-attention model (DeepSeekV2Config) "
                         "runs its own latent path; attention_impl names "
                         "the K/V-pool attentions and stays 'grouped' "
                         "for it")
    if model_cfg.is_mla and tp > 1:
        raise ValueError("latent attention and routed experts run on one "
                         "device; the tensor-parallel mesh does not split "
                         "them")


def init_auto_state(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                    n_requests: int, device=None,
                    sample_seed: int | None = None, tp: int = 1) -> AutoState:
    """The free list holds unit ids and a slot's page-table row is made of
    contiguous units: one W-page group under full grant, two W/2-page
    halves under overcommit (an ungrown slot's second half repeats its
    first). ``sample_seed``: the sampling key's seed (None = greedy, no
    key). ``device``: ``cuda`` unless the caller names another (raises
    without a GPU). ``tp`` > 1: a tensor-parallel rank's state, whose
    pools hold D/tp features."""
    dev = resolve_device(device)
    B = engine_cfg.n_slots
    W = engine_cfg.pages_per_slot(model_cfg.n_seq)
    oc = engine_cfg.overcommit
    NG = engine_cfg.n_pages // (W // 2 if oc else W)

    def zeros(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return AutoState(
        kv=init_paged_state(model_cfg, engine_cfg, dev, tp=tp),
        page_table=zeros(B, W),
        lengths=zeros(B),
        last_tokens=zeros(B),
        rid=zeros(B),
        allocated=zeros(B, dtype=torch.bool),
        queue_head=zeros(),
        free_top=torch.full((), NG, dtype=I32, device=dev),
        page_stack=torch.arange(NG, dtype=I32, device=dev),
        out_tokens=zeros(n_requests, model_cfg.n_seq),
        final_lens=zeros(n_requests),
        rng_key=(None if sample_seed is None
                 else prng_key(sample_seed, dev)),
        grown=zeros(B, dtype=torch.bool) if oc else None,
        adm_seq=zeros(B) if oc else None,
        seq_ctr=zeros() if oc else None,
        retry_stack=zeros(n_requests) if oc else None,
        retry_top=zeros() if oc else None,
        preempted=zeros() if oc else None,
    )


def _status_of(st: AutoState):
    """The 5-int status (live, queue head, free units, retry depth,
    finished count). Free units counts the stack plus the units of
    dead-but-allocated slots (two for a grown one), which the next burst
    frees."""
    dead_alloc = (st.lengths == 0) & st.allocated
    units = dead_alloc.sum(dtype=I32)
    if st.grown is not None:
        units = units + (dead_alloc & st.grown).sum(dtype=I32)
    return torch.stack([
        (st.lengths > 0).sum(dtype=I32),
        st.queue_head,
        st.free_top + units,
        torch.zeros_like(st.queue_head) if st.retry_top is None
        else st.retry_top,
        (st.final_lens > 0).sum(dtype=I32),
    ])


class Admission(NamedTuple):
    """What an admission step hands the rest of a sub-burst: the state's
    slot fields after freeing, growth, preemption and admission, and the
    admitted wave ([max_new] rows, the first m of them admitted)."""

    page_table: torch.Tensor
    lengths: torch.Tensor
    last_tokens: torch.Tensor
    rid: torch.Tensor
    allocated: torch.Tensor
    queue_head: torch.Tensor
    free_top: torch.Tensor
    page_stack: torch.Tensor
    granted: torch.Tensor      # [max_new, W] page rows of the wave
    plens: torch.Tensor        # [max_new] prompt lengths (0 = not admitted)
    prompts: torch.Tensor      # [max_new, S_pre]
    m: torch.Tensor            # [] admitted count
    slot_ids: torch.Tensor     # [max_new] slots (B = not admitted)
    oc: dict                   # the overcommit fields of AutoState


def _full_grant_admission(engine_cfg: EngineConfig, max_new: int,
                          st: AutoState, prompts_all, plens_all,
                          n_real) -> Admission:
    """Free the page groups of dead-but-allocated slots (group id = first
    page // W), then pop the queue head into dead slots, one group each."""
    dev = st.lengths.device
    B, W = st.page_table.shape
    NG = engine_cfg.n_pages // W
    R_total, S_pre = prompts_all.shape
    j = torch.arange(max_new, dtype=I32, device=dev)

    to_free = (st.lengths == 0) & st.allocated
    free_ord = torch.cumsum(to_free, 0, dtype=I32) - 1
    push_pos = torch.where(to_free, st.free_top + free_ord, NG)
    page_stack = index_set_drop_(st.page_stack.clone(), push_pos,
                                 st.page_table[:, 0] // W)
    free_top = st.free_top + to_free.sum(dtype=I32)
    allocated = st.allocated & ~to_free

    dead = ~allocated
    m = torch.minimum(dead.sum(dtype=I32).clamp_max(max_new),
                      torch.minimum(n_real - st.queue_head, free_top))
    # ascending dead slot ids first (jnp.nonzero(size=B) without a sync)
    slot_order = torch.sort((~dead).to(torch.int8), stable=True).indices
    admit = j < m
    slot_ids = torch.where(admit, slot_order[:max_new].to(I32), B)
    # rids are global request indices; buffer rows are rid % R_total
    req_ix = st.queue_head + j
    req_row = (req_ix % R_total).long()
    plens = torch.where(admit, plens_all[req_row], 0)
    if engine_cfg.sort_admits:
        # the admitted wave in prompt-length order (stable): the admitted
        # set and the queue advance are unchanged; slots and groups are
        # assigned in that order (greedy outputs do not depend on them)
        order = torch.sort(torch.where(admit, plens, 1 << 30),
                           stable=True).indices
        req_ix, req_row, plens = req_ix[order], req_row[order], plens[order]
    prompts = prompts_all[req_row]                      # [max_new, S_pre]
    # the j-th admitted request pops page_stack[free_top - 1 - j]
    gids = page_stack[(free_top - 1 - j).clamp(0, NG - 1).long()]
    granted = gids[:, None] * W + torch.arange(W, dtype=I32, device=dev)
    page_table = index_set_drop_(st.page_table.clone(), slot_ids, granted)
    lengths = index_set_drop_(st.lengths.clone(), slot_ids, plens)
    last_prompt_tok = prompts[j.long(), (plens - 1).clamp(0, S_pre - 1).long()]
    last_tokens = index_set_drop_(st.last_tokens.clone(), slot_ids,
                                  last_prompt_tok)
    rid = index_set_drop_(st.rid.clone(), slot_ids, req_ix)
    allocated = allocated | index_set_drop_(
        torch.zeros_like(allocated), slot_ids, torch.ones_like(admit))
    return Admission(page_table, lengths, last_tokens, rid, allocated,
                     st.queue_head + m, free_top - m, page_stack, granted,
                     plens, prompts, m, slot_ids, {})


def _overcommit_admission(engine_cfg: EngineConfig, max_new: int, R: int,
                          st: AutoState, prompts_all, plens_all,
                          n_real) -> Admission:
    """Paged scheduling with overcommit, on the device, in half-group
    units (W/2 contiguous pages): free dead slots' halves -> grow live
    slots that this sub-burst's R rounds take past their first half ->
    preempt the YOUNGEST live slots while growth does not fit (their rids
    go on the retry stack) -> admit retry-stack rids (LIFO), then
    queue-head rids, one half each, two when the prompt plus the lookahead
    does not fit a half. The JAX engine's _overcommit_admission, with
    stable sorts where it sorts and no host read."""
    dev = st.lengths.device
    B, W = st.page_table.shape
    Hp = W // 2
    P = engine_cfg.page_size
    NH = engine_cfg.n_pages // Hp
    R_total, S_pre = prompts_all.shape
    units = torch.arange(Hp, dtype=I32, device=dev)[None, :]

    page_table, lengths = st.page_table, st.lengths
    grown = st.grown
    retry_top = st.retry_top

    def push_units(stack, top, mask1, units1, mask2, units2):
        ord1 = torch.cumsum(mask1, 0, dtype=I32) - 1
        index_set_drop_(stack, torch.where(mask1, top + ord1, NH), units1)
        top = top + mask1.sum(dtype=I32)
        ord2 = torch.cumsum(mask2, 0, dtype=I32) - 1
        index_set_drop_(stack, torch.where(mask2, top + ord2, NH), units2)
        return top + mask2.sum(dtype=I32)

    h1 = page_table[:, 0] // Hp
    h2 = page_table[:, Hp] // Hp

    # ---- free dead-but-allocated slots' halves ----
    to_free = (lengths == 0) & st.allocated
    page_stack = st.page_stack.clone()
    free_top = push_units(page_stack, st.free_top, to_free, h1,
                          to_free & grown, h2)
    allocated = st.allocated & ~to_free
    grown = grown & ~to_free
    live = lengths > 0

    # ---- growth demand: this sub-burst writes positions up to len + R - 2
    need2 = live & ~grown & (lengths + R - 1 > Hp * P)
    n_need = need2.sum(dtype=I32)

    # ---- preempt the youngest live slots until growth fits ----
    key = torch.where(live, st.adm_seq, -1)
    order = torch.sort(-key, stable=True).indices            # youngest first
    freed_cum = torch.cumsum(
        torch.where(live, 1 + grown.to(I32), 0)[order], 0, dtype=I32)
    need_cum = torch.cumsum(need2.to(I32)[order], 0, dtype=I32)
    ok = torch.cat([(free_top >= n_need).reshape(1),
                    free_top + freed_cum >= n_need - need_cum])
    k_star = (~ok).sum(dtype=I32)       # monotone: the first-True index
    rank = torch.zeros(B, dtype=I32, device=dev).scatter_(
        0, order, torch.arange(B, dtype=I32, device=dev))
    preempt = live & (rank < k_star)
    p_ord = torch.cumsum(preempt, 0, dtype=I32) - 1
    retry_stack = index_set_drop_(
        st.retry_stack.clone(),
        torch.where(preempt, retry_top + p_ord, R_total), st.rid)
    n_preempt = preempt.sum(dtype=I32)
    retry_top = retry_top + n_preempt
    free_top = push_units(page_stack, free_top, preempt, h1,
                          preempt & grown, h2)
    lengths = torch.where(preempt, 0, lengths)
    allocated = allocated & ~preempt
    grown = grown & ~preempt
    need2 = need2 & ~preempt

    # ---- grow: pop one half per remaining candidate (fits by k_star) ----
    g_ord = torch.cumsum(need2, 0, dtype=I32) - 1
    g_pop = page_stack[(free_top - 1 - g_ord).clamp(0, NH - 1).long()]
    second = torch.where(need2, g_pop, h2)[:, None] * Hp + units
    page_table = torch.where(need2[:, None],
                             torch.cat([page_table[:, :Hp], second], dim=1),
                             page_table)
    free_top = free_top - need2.sum(dtype=I32)
    grown = grown | need2

    # ---- admission: the retry stack first (LIFO), then the queue head;
    # one half each, two if the prompt + lookahead cannot fit a half ----
    dead = ~allocated
    n_retry = retry_top
    remaining = (n_real - st.queue_head).clamp_min(0)
    j = torch.arange(max_new, dtype=I32, device=dev)
    from_retry = j < n_retry
    r_idx = (retry_top - 1 - j).clamp(0, R_total - 1).long()
    rid_vec = torch.where(from_retry, retry_stack[r_idx],
                          st.queue_head + j - n_retry)
    # rids are global; buffer rows are rid % R_total
    row_vec = (rid_vec.clamp_min(0) % R_total).long()
    plens_cand = plens_all[row_vec]
    hneed = 1 + (plens_cand + R - 1 > Hp * P).to(I32)
    hcum = torch.cumsum(hneed, 0, dtype=I32)
    m_basic = torch.minimum(dead.sum(dtype=I32).clamp_max(max_new),
                            n_retry + remaining)
    admit = (j < m_basic) & (hcum <= free_top)            # prefix-closed
    m = admit.sum(dtype=I32)
    slot_order = torch.sort((~dead).to(torch.int8), stable=True).indices
    slot_ids = torch.where(admit, slot_order[:max_new].to(I32), B)
    plens = torch.where(admit, plens_cand, 0)
    prompts = prompts_all[row_vec]
    off1 = hcum - hneed
    u1 = page_stack[(free_top - 1 - off1).clamp(0, NH - 1).long()]
    u2 = page_stack[(free_top - hcum).clamp(0, NH - 1).long()]
    two = hneed == 2
    first = u1[:, None] * Hp + units
    # an ungrown slot's second half REPEATS its first: never read (lengths
    # stay below Hp*P until it grows) and never written
    sec = torch.where(two[:, None], u2[:, None] * Hp + units, first)
    granted = torch.cat([first, sec], dim=1)              # [max_new, W]
    page_table = index_set_drop_(page_table.clone(), slot_ids, granted)
    free_top = free_top - torch.where(admit, hneed, 0).sum(dtype=I32)
    n_from_retry = torch.minimum(m, n_retry)
    retry_top = retry_top - n_from_retry
    queue_head = st.queue_head + (m - n_from_retry)
    lengths = index_set_drop_(lengths.clone(), slot_ids, plens)
    last_prompt_tok = prompts[j.long(), (plens - 1).clamp(0, S_pre - 1).long()]
    last_tokens = index_set_drop_(st.last_tokens.clone(), slot_ids,
                                  last_prompt_tok)
    rid = index_set_drop_(st.rid.clone(), slot_ids, rid_vec)
    allocated = allocated | index_set_drop_(
        torch.zeros_like(allocated), slot_ids, torch.ones_like(admit))
    grown = index_set_drop_(grown.clone(), slot_ids, two)
    adm_seq = index_set_drop_(st.adm_seq.clone(), slot_ids, st.seq_ctr + j)
    oc = dict(grown=grown, adm_seq=adm_seq, seq_ctr=st.seq_ctr + m,
              retry_stack=retry_stack, retry_top=retry_top,
              preempted=st.preempted + n_preempt)
    return Admission(page_table, lengths, last_tokens, rid, allocated,
                     queue_head, free_top, page_stack, granted, plens,
                     prompts, m, slot_ids, oc)


def _new_rings(engine_cfg: EngineConfig, kv: PagedKVState, n_rounds: int):
    """Zeroed per-layer rings [B, R_pad, 2*D] at the pools' feature width D
    (local under tp; int4 rows ride unpacked, one int8 per feature) and,
    for quantized pools, [B, 128] f32 scale columns."""
    B = engine_cfg.n_slots
    pool = kv.kv_pages[0]
    dev = pool.device
    feat = pool.shape[-1] * (2 if engine_cfg.kv_packed else 1)
    shape = (B, ring_pad_rows(n_rounds), 2 * feat)
    L = len(kv.kv_pages)
    rings = [torch.zeros(shape, dtype=engine_cfg.kv_torch_dtype, device=dev)
             for _ in range(L)]
    scs = ([torch.zeros((B, 128), dtype=torch.float32, device=dev)
            for _ in range(L)] if engine_cfg.kv_quantized else [None] * L)
    return rings, scs


def _prefill_sizes(max_new: int) -> list:
    """The prefill block sizes of a sub-burst admitting up to max_new."""
    return [s for s in (64, 128, 256) if s < max_new] + [max_new]


def _prefill_bucket(m, sizes) -> torch.Tensor:
    """The device int that picks the prefill block for ``m`` admitted
    requests: 0 for none, else 1 + the index of the smallest size that
    holds them (JAX: ``sum(m > t)`` over the thresholds)."""
    return sum((m > t).to(I32) for t in [0] + sizes[:-1])


def _sub_burst(model_cfg: ModelConfig, engine_cfg: EngineConfig,
               attention_impl: str, max_new: int, ctx, sampling, R: int,
               round_offset: int, ring_ctx, do_flush: bool, params,
               st: AutoState, prompts_all, plens_all, n_real, counts):
    """One admit -> prefill -> R decode rounds. ``ring_ctx`` (rings, scale
    columns, ring_start, ring_r0) is the burst-wide ring threaded across
    sub-bursts, or None (a fresh ring per sub-burst when ring decode is on);
    ``round_offset`` is the absolute round of this sub-burst's first round
    and ``do_flush`` lands the ring in the pages at its end. ``sampling``:
    None (greedy) or (temperature, top_k), each round then splitting
    ``st.rng_key``. Pools, outputs and ``counts`` are written in place.
    Returns (state, ring_ctx, host syncs made)."""
    NP = engine_cfg.n_pages
    P = engine_cfg.page_size
    S = model_cfg.n_seq
    R_total, S_pre = prompts_all.shape

    # ---- 1-2. free, (overcommit: grow, preempt,) admit ----
    with phase("admit"):
        if engine_cfg.overcommit:
            adm = _overcommit_admission(engine_cfg, max_new, R, st,
                                        prompts_all, plens_all, n_real)
        else:
            adm = _full_grant_admission(engine_cfg, max_new, st, prompts_all,
                                        plens_all, n_real)
    (page_table, lengths, last_tokens, rid, allocated, queue_head, free_top,
     page_stack, granted, plens, prompts, m, slot_ids, oc) = adm

    # ---- 3. prefill the admitted prompts over the smallest bucket of rows
    # that holds them (the first m rows of the max_new block), picked on
    # the device (JAX: lax.switch) ----
    kv = st.kv
    heads = ctx.local_heads(model_cfg)
    scale_reduce = scale_reduce_of(ctx)
    sizes = _prefill_sizes(max_new)

    mla = model_cfg.is_mla
    expert_counts = counts[_EXPERT_ROWS:_EXPERT_ROWS_MAX + 1]

    def prefill(bs):
        def run():
            if mla:
                write, _ = make_latent_prefill_writer(
                    kv, granted[:bs], plens[:bs], S_pre, P, NP)
                deepseek_v2.prefill_write_kv(
                    params, model_cfg, prompts[:bs], plens[:bs], write,
                    expert_counts=expert_counts)
                return
            write_kv_block, _ = make_prefill_kv_writer(
                kv, granted[:bs], plens[:bs], S_pre, P, NP, scale_reduce,
                n_heads=heads)
            prefill_write_kv(params, model_cfg, prompts[:bs], plens[:bs],
                             write_kv_block, ctx)
        return run

    with phase("prefill"):
        syncs = device_switch(_prefill_bucket(m, sizes),
                              [None] + [prefill(s) for s in sizes])
    counts[_PREFILLS].add_((m > 0).long())

    # ---- 4. decode rounds; the tokens scatter into the output buffers once
    # per sub-burst ----
    # Ring decode: ring_start = the first position this (sub-)burst
    # computes (burst-start length - 1, or the last prompt token of an
    # admittee, whose page row the flush rewrites with the bytes prefill
    # wrote). The pools stay read-only until the flush.
    use_ring = engine_cfg.decode_ring and attention_impl == "grouped"
    if ring_ctx is not None:
        # burst-wide ring: this sub-burst's admittees start at its first
        # absolute round; earlier columns held a previous occupant's rows
        rings, ring_scs, ring_start, ring_r0 = ring_ctx
        ring_start = index_set_drop_(ring_start.clone(), slot_ids,
                                     torch.clamp_min(plens - 1, 0))
        ring_r0 = index_set_drop_(ring_r0.clone(), slot_ids,
                                  torch.full_like(plens, round_offset))
        flush_rounds = engine_cfg.n_forward_rounds
        col_base = round_offset
    elif use_ring:
        rings, ring_scs = _new_rings(engine_cfg, kv, R)
        ring_start = torch.clamp_min(lengths - 1, 0)
        ring_r0 = None
        flush_rounds = R
        col_base = 0
    kv_pages, k_scales, v_scales = (list(kv.kv_pages), list(kv.k_scales),
                                    list(kv.v_scales))
    row = rid % R_total
    key = st.rng_key
    toks, out_idx, fin_rid, fin_len = [], [], [], []
    round_tokens = (functools.partial(deepseek_v2.decode_round_tokens,
                                      expert_counts=expert_counts)
                    if mla else decode_round_tokens)
    for r in range(R):
        live = lengths > 0
        if mla:
            write_kv, attend = make_latent_round_callbacks(
                page_table, kv_pages, lengths, P, NP, params["mla_scale"],
                model_cfg.kv_lora_rank)
        elif use_ring:
            write_kv, attend = make_ring_round_callbacks(
                model_cfg, engine_cfg, page_table, kv_pages, k_scales,
                v_scales, rings, ring_scs, lengths, ring_start, col_base + r,
                ring_r0=ring_r0, n_heads=heads, scale_reduce=scale_reduce)
        else:
            write_kv, attend = make_round_kv_callbacks(
                model_cfg, engine_cfg, attention_impl, page_table,
                kv_pages, k_scales, v_scales, lengths, n_heads=heads,
                scale_reduce=scale_reduce)
        if sampling is None:
            tok, new_lengths = round_tokens(
                params, model_cfg, lengths, last_tokens, write_kv, attend,
                ctx)
        else:
            def draw(logits, lens, key=key):
                return sample_next_token(
                    logits, lens, key, n_seq=S,
                    eof_token_id=model_cfg.eof_token_id,
                    temperature=sampling[0], top_k=sampling[1])

            tok, new_lengths, key = round_tokens(
                params, model_cfg, lengths, last_tokens, write_kv, attend,
                ctx, next_token_fn=draw)
        # the emitted token's position in its sequence is the old length
        toks.append(tok)
        out_idx.append(torch.where(live, row * S + lengths, R_total * S))
        fin_rid.append(torch.where(live & (new_lengths == 0), row, R_total))
        fin_len.append(lengths + 1)
        last_tokens = torch.where(live, tok, last_tokens)
        lengths = new_lengths
    if use_ring and do_flush:
        with phase("ring"):
            for pool, rg in zip(kv_pages, rings):
                if engine_cfg.kv_packed:
                    rg = pack_ring_for_flush(rg, heads)
                ring_flush(pool, rg, ring_start, lengths, page_table,
                           n_rounds=flush_rounds, ring_r0=ring_r0)
    index_set_drop_(st.out_tokens.view(-1), torch.cat(out_idx),
                    torch.cat(toks))
    index_set_drop_(st.final_lens, torch.cat(fin_rid), torch.cat(fin_len))

    new_st = AutoState(kv, page_table, lengths, last_tokens, rid, allocated,
                       queue_head, free_top, page_stack, st.out_tokens,
                       st.final_lens, key, **oc)
    ring_ctx_out = (None if ring_ctx is None
                    else (rings, ring_scs, ring_start, ring_r0))
    return new_st, ring_ctx_out, syncs


def _state_tensors(st: AutoState) -> list:
    """Every tensor of a state, pools and scales first, in a fixed order."""
    kv = st.kv
    out = [t for t in (*kv.kv_pages, *kv.k_scales, *kv.v_scales)
           if t is not None]
    return out + [t for t in st[1:] if t is not None]


def _store_(dst: AutoState, src: AutoState) -> None:
    """Copy a burst's new state into the state's own buffers."""
    for d, s in zip(_state_tensors(dst), _state_tensors(src)):
        if d is not s:
            d.copy_(s)


def _reset_state_(st: AutoState, n_units: int, key0) -> None:
    """Bring a state's buffers back to init_auto_state's values (``key0``:
    the sampling key at the start, or None)."""
    for t in _state_tensors(st):
        t.zero_()
    if key0 is not None:
        st.rng_key.copy_(key0)
    st.free_top.fill_(n_units)
    torch.arange(n_units, dtype=I32, device=st.page_stack.device,
                 out=st.page_stack)


def _autonomous_burst(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                      attention_impl: str, max_new: int, ctx, sampling,
                      params, st: AutoState, prompts_all, plens_all, n_real,
                      counts, status, round_counts) -> int:
    """One burst, in place on ``st``'s buffers: ``subbursts`` repetitions
    of admit -> prefill -> decode (n_forward_rounds / subbursts rounds
    each), so dead slots refill every R/subbursts rounds while the host
    pays one status read per chunk. One liveness gate covers the whole
    burst (JAX: ``lax.cond``): with no live slot and nothing queued the
    burst changes no state tensor. ``n_real`` is the device count of real
    requests; ``counts`` gets the skipped burst, the rounds and
    slot-rounds (``round_counts``: [rounds, width x rounds] int64, one add)
    and the prefill blocks; ``status`` the 5-int status after the burst.
    Its phases (utils/profiling) are ``burst`` (inside the gate),
    ``admit``, ``prefill``, ``ring`` and ``logits``. Returns the host
    syncs made (reads of the gate and the bucket on CUDA without capture;
    none on the CPU or in a graph).

    With ring decode, ``burst_flush`` and ``subbursts > 1``, one ring sized
    for the whole burst rides across the sub-bursts and is flushed once at
    burst end; otherwise each sub-burst flushes its own ring."""
    pending = st.queue_head < n_real
    if engine_cfg.overcommit:
        pending = pending | (st.retry_top > 0)
    go = (st.lengths > 0).any() | pending
    counts[_SKIPPED].add_((~go).long())
    inner = []

    def run_subbursts():
        with phase("burst"):
            n_sub = engine_cfg.subbursts
            r_sub = engine_cfg.n_forward_rounds // n_sub
            use_ring = engine_cfg.decode_ring and attention_impl == "grouped"
            burst_ring = use_ring and engine_cfg.burst_flush and n_sub > 1
            ring_ctx = None
            if burst_ring:
                rings, ring_scs = _new_rings(engine_cfg, st.kv,
                                             engine_cfg.n_forward_rounds)
                # slots live at burst start: first new position = length
                # - 1, first ring column 0; admissions overwrite their
                # entries
                ring_ctx = (rings, ring_scs,
                            torch.clamp_min(st.lengths - 1, 0),
                            torch.zeros_like(st.lengths))
            cur = st
            for k in range(n_sub):
                cur, ring_ctx, syncs = _sub_burst(
                    model_cfg, engine_cfg, attention_impl, max_new, ctx,
                    sampling, r_sub,
                    k * r_sub, ring_ctx, (not burst_ring) or k == n_sub - 1,
                    params, cur, prompts_all, plens_all, n_real, counts)
                inner.append(syncs)
            counts[_ROUNDS:_SLOT_ROUNDS + 1].add_(round_counts)
            _store_(st, cur)

    syncs = device_if(go, run_subbursts)
    status.copy_(_status_of(st))
    return syncs + sum(inner)


def _compact_slice(st: AutoState, b_new: int) -> AutoState:
    """Drain-phase compaction: stable-sort live slots to the front and keep
    b_new slot rows. Valid once the queue is drained (nothing is admitted
    again) and at most b_new slots are live (checked by the caller)."""
    order = torch.sort((st.lengths == 0).to(torch.int8), stable=True).indices
    sel = order[:b_new]
    return st._replace(
        lengths=st.lengths[sel],
        last_tokens=st.last_tokens[sel],
        rid=st.rid[sel],
        allocated=st.allocated[sel],
        page_table=st.page_table[sel],
        grown=None if st.grown is None else st.grown[sel],
        adm_seq=None if st.adm_seq is None else st.adm_seq[sel],
    )


# the per-slot fields of AutoState: an executed width has buffers of its own
_SLOT_FIELDS = ("page_table", "lengths", "last_tokens", "rid", "allocated",
                "grown", "adm_seq")
# device counters of a program, before the kernel launch counts
(_SKIPPED, _ROUNDS, _SLOT_ROUNDS, _PREFILLS, _EXPERT_ROWS,
 _EXPERT_ROWS_MAX) = range(6)
_N_STATS = 6


def _round_increments(R: int, b: int, dev) -> torch.Tensor:
    """[R, b * R] int64 on ``dev`` (a burst's rounds and slot-rounds at
    width b), made without a copy from pageable host memory, which would
    sync."""
    t = torch.full((2,), R, dtype=torch.int64, device=dev)
    t[1:].fill_(b * R)
    return t


class _Program:
    """The burst over fixed buffers: the state at each executed width (the
    per-slot fields are the width's own, the rest shared), the request
    queue (prompts, prompt lengths, the device count ``n_real``), the
    device counters the burst writes (int64: skipped, rounds, slot-rounds,
    prefills, then the kernel launches recorded into a graph), the status
    and the device phase table (utils/profiling: the device spans of
    graphs captured with tracing on; ``stamped`` says whether they hold
    any).

    ``burst(b)`` runs one burst at width b: eagerly (the CPU; CUDA with
    capture off), or on CUDA, once ``capture()`` has run, as the replay of
    that width's graph: one host call, no read."""

    def __init__(self, engine: "AutonomousEngine", cap: int, s_pre: int,
                 widths):
        # no reference to the engine: a cycle would leave the graphs to the
        # cyclic collector, which may free one during another capture
        self.device = dev = engine.device
        ecfg = engine.engine_cfg
        self.full = ecfg.n_slots
        full = init_auto_state(engine.model_cfg, ecfg, cap, dev,
                               engine.sample_seed, tp=engine.ctx.tp)
        self.key0 = None if full.rng_key is None else full.rng_key.clone()
        self.st = {ecfg.n_slots: full}
        for b in widths[1:]:
            self.st[b] = full._replace(**{
                f: torch.zeros((b,) + getattr(full, f).shape[1:],
                               dtype=getattr(full, f).dtype, device=dev)
                for f in _SLOT_FIELDS if getattr(full, f) is not None})
        self.n_units = full.page_stack.shape[0]
        self.prompts = torch.zeros((cap, s_pre), dtype=I32, device=dev)
        self.plens = torch.zeros(cap, dtype=I32, device=dev)
        self.n_real = torch.zeros((), dtype=I32, device=dev)
        self.counts = torch.zeros(_N_STATS + _build.MAX_COUNTED,
                                  dtype=torch.int64, device=dev)
        self.status = torch.zeros(5, dtype=I32, device=dev)
        self.phase_table = profiling.new_device_table(dev)
        self.stamped = False
        R = ecfg.n_forward_rounds
        # the burst at each width, over these buffers
        self._bodies = {b: functools.partial(
            _autonomous_burst, engine.model_cfg,
            ecfg if b == ecfg.n_slots else dataclasses.replace(
                ecfg, n_slots=b),
            engine.attention_impl, min(engine.max_new, b), engine.ctx,
            engine.sampling, engine.params, st, self.prompts, self.plens,
            self.n_real, self.counts, self.status,
            _round_increments(R, b, dev))
            for b, st in self.st.items()}
        self.graphs = {}

    def burst(self, b: int) -> int:
        """One burst at width b; returns the host syncs it made."""
        if b in self.graphs:
            self.graphs[b].replay()
            return 0
        return self._bodies[b]()

    def capture(self, dot_dir: str | None = None) -> None:
        """Capture every width's burst into a CUDA graph, after one eager
        burst per width that runs every branch (graph.warming) on the
        capture stream; then reset the state. The graphs share their memory
        pools (they never replay concurrently). With ``dot_dir``, each
        graph is also written there as ``burst-<width>.dot``. With the
        program's tracing on, the graphs time their phases on the device."""
        dev = self.device
        stream = capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream), warming():
            for body in self._bodies.values():
                body()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.reset()
        # the eager bursts' freed blocks stay cached in the allocator's
        # common pool, where a graph's private pools cannot take them: hand
        # them back first (a model whose weights and pool fill most of the
        # card has no room for the graphs beside them)
        torch.cuda.empty_cache()
        pools = new_pools()
        info = {}
        self.stamped = profiling.tracing()
        for b in self.st:
            dot = os.path.join(dot_dir, f"burst-{b}.dot") if dot_dir else None
            g = capture(self._bodies[b], dev, pools, self.counts[_N_STATS:],
                        dot, self.phase_table)
            self.graphs[b] = g
            info[b] = dict(capture_s=g.capture_s,
                           instantiate_s=g.instantiate_s,
                           pool_bytes=g.pool_bytes,
                           nodes=count_dot_nodes(dot) if dot else None)
        self.graph_info = info

    def reset(self) -> None:
        """The initial state and zero counters (every width's per-slot
        buffers are written by the compaction before that width runs)."""
        _reset_state_(self.st[self.full], self.n_units, self.key0)
        self.counts.zero_()
        self.phase_table.zero_()

    def compact(self, b_from: int, b_to: int) -> None:
        """Drain downshift: the live slots of width b_from into width
        b_to's buffers (eager, between chunks)."""
        src = _compact_slice(self.st[b_from], b_to)
        dst = self.st[b_to]
        for f in _SLOT_FIELDS:
            if getattr(dst, f) is not None:
                getattr(dst, f).copy_(getattr(src, f))

    def count_vector(self) -> torch.Tensor:
        """The device counters and, last, the preemptions so far (int64)."""
        st = self.st[self.full]
        pre = (torch.zeros_like(self.n_real) if st.preempted is None
               else st.preempted)
        return torch.cat([self.counts, pre.view(1).long()])

    def fold_phases(self) -> int:
        """Where the graphs time their phases: the device phase table
        into the global PhaseStats, and zeroed. Returns the host syncs made
        (one read, or none)."""
        if not self.stamped:
            return 0
        profiling.fold_device(self.phase_table.cpu().numpy())
        self.phase_table.zero_()
        return 1


def check_prompts(requests: List[Request], n_seq: int) -> None:
    """Raise ValueError for a prompt length outside [1, n_seq - 1]."""
    for req in requests:
        if not 0 < len(req.tokens) < n_seq:
            raise ValueError(f"request {req.id}: prompt length "
                             f"{len(req.tokens)} not in [1, {n_seq - 1}]")


def prompt_bucket(requests: List[Request], n_seq: int) -> int:
    """The prompt block width of a queue: the next power of two of its
    longest prompt, at most n_seq."""
    max_plen = max(len(r.tokens) for r in requests)
    return min(n_seq, 1 << (max_plen - 1).bit_length())


def _int64(halves: np.ndarray) -> np.ndarray:
    """int64 values pulled to the host as int32 pairs."""
    return np.ascontiguousarray(halves, dtype=np.int32).view(np.int64)


def _fold_counts(stats: "BurstStats", counts: np.ndarray) -> None:
    """Add a pulled count_vector() to ``stats`` (preemptions too) and the
    launches recorded into graphs to the kernel wrappers."""
    stats.skipped += int(counts[_SKIPPED])
    stats.rounds += int(counts[_ROUNDS])
    stats.prefills += int(counts[_PREFILLS])
    stats.slot_rounds += int(counts[_SLOT_ROUNDS])
    stats.expert_rows += int(counts[_EXPERT_ROWS])
    stats.expert_rows_max += int(counts[_EXPERT_ROWS_MAX])
    stats.preemptions += int(counts[-1])
    _build.add_device_counts(counts[_N_STATS:-1])


class AutonomousEngine:
    """Continuous-batching engine with the scheduler on the device.

    ``attention_impl``: ``"grouped"`` (the CUDA kernels: the fused-write
    kernel, or with ``decode_ring`` the ring partial of the configured
    formulation; their plain versions on the CPU), ``"torch"`` (scatter +
    the gather oracle, no ring). A latent-attention model
    (``DeepSeekV2Config``) takes the latent pool and the absorbed decode
    kernel (ops/mla_decode.py) by its ``is_mla``, and refuses any
    ``attention_impl`` but the default. ``temperature > 0``
    samples (with ``top_k`` > 0 keeping the k largest logits) from the key
    of ``sample_seed``, as the JAX engine does; 0 decodes greedily.
    ``device``: ``cuda`` unless the caller names another; raises without a
    GPU. ``params`` are tensors on that device (models.params_from_numpy,
    models.init_params), dense or weight-quantized (ops/quant).

    On CUDA a burst is one CUDA graph per executed width, captured at the
    first run of a queue shape (request capacity, prompt bucket) and
    replayed by later runs of that shape; ``graph_info`` holds what the
    latest capture cost, by width. ``_capture=False`` keeps the eager CUDA
    path, which reads the gate and the bucket on the host: a check path for
    tests, never a fallback. ``_graph_dot_dir``: write each captured graph
    there (Graphviz) and count its nodes into ``graph_info``.

    ``ctx``: the parallel context; a mesh rank (parallel/autonomous.py)
    passes its TpShardCtx with its local params and its dp group's config.
    """

    def __init__(
        self,
        params,
        model_cfg: ModelConfig,
        engine_cfg: EngineConfig,
        attention_impl: str = "grouped",
        max_new_per_burst: int = 128,
        bursts_per_chunk: int = 4,
        request_capacity: int | None = None,
        min_drain_slots: int | None = None,
        temperature: float = 0.0,
        top_k: int = 0,
        sample_seed: int = 0,
        device=None,
        ctx=DEFAULT_CTX,
        _capture: bool = True,
        _graph_dot_dir: str | None = None,
    ):
        model_cfg.validate()
        engine_cfg.validate(model_cfg)
        _check_supported(model_cfg, attention_impl, ctx.tp)
        self.device = resolve_device(device)
        if params_device(params).type != self.device.type:
            raise ValueError(f"params are on {params_device(params)}, the "
                             f"engine runs on {self.device}")
        self.params = (deepseek_v2.prepare_params(params, model_cfg)
                       if model_cfg.is_mla else fuse_qkv_params(params))
        self.model_cfg = model_cfg
        self.engine_cfg = engine_cfg
        self.ctx = ctx
        self.max_new = min(max_new_per_burst, engine_cfg.n_slots)
        self.chunk = bursts_per_chunk
        self.request_capacity = request_capacity
        self.attention_impl = attention_impl
        # drain downshift floor; n_slots = disabled
        self.min_drain_slots = (max(8, min_drain_slots) if min_drain_slots
                                else engine_cfg.n_slots)
        # temperature > 0 samples (ops/sampling); host engines stay greedy,
        # which their preemption recompute relies on
        self.sampling = ((float(temperature), int(top_k)) if temperature > 0
                         else None)
        self.sample_seed = sample_seed if self.sampling else None
        self.use_graphs = self.device.type == "cuda" and _capture
        self.graph_dot_dir = _graph_dot_dir
        self.graph_info = {}
        self.stats = BurstStats()
        self._run_key = self._run_program = None

    def _widths(self) -> list:
        """The executed widths, widest first: n_slots, halved down to the
        drain floor."""
        widths = [self.engine_cfg.n_slots]
        while widths[-1] // 2 >= self.min_drain_slots:
            widths.append(widths[-1] // 2)
        return widths

    def _program(self, cap: int, s_pre: int, widths) -> _Program:
        """A new program over a queue of ``cap`` prompts of ``s_pre``
        tokens, captured on CUDA (the capture's seconds and memory go to
        ``graph_info``)."""
        prog = _Program(self, cap, s_pre, widths)
        if self.use_graphs:
            prog.capture(self.graph_dot_dir)
            self.graph_info = prog.graph_info
            self.stats.captures += len(widths)
        return prog

    def _queue(self, requests: List[Request], cap: int, s_pre: int):
        """The padded prompt queue of ``requests``: ([cap, s_pre] prompts,
        [cap] lengths) as numpy int32. Raises for a prompt length outside
        [1, n_seq - 1]."""
        check_prompts(requests, self.model_cfg.n_seq)
        prompts_all = np.zeros((cap, s_pre), dtype=np.int32)
        plens_all = np.zeros(cap, dtype=np.int32)
        for i, req in enumerate(requests):
            prompts_all[i, : len(req.tokens)] = req.tokens
            plens_all[i] = len(req.tokens)
        return prompts_all, plens_all

    def _load(self, prompts_all, plens_all, n: int) -> _Program:
        """The program of this queue shape (one per shape, the last one
        kept), reset, with the queue and its count ``n`` uploaded."""
        key = prompts_all.shape
        if self._run_key != key:
            self._run_program = None
            self._run_program = self._program(*key, self._widths())
            self._run_key = key
        prog = self._run_program
        prog.reset()
        prog.prompts.copy_(torch.from_numpy(prompts_all))
        prog.plens.copy_(torch.from_numpy(plens_all))
        self.stats.host_syncs += 2  # blocking uploads (pageable memory)
        prog.n_real.fill_(n)
        return prog

    def run(self, item_storage: ItemStorage) -> None:
        counter = get_global_throughput_counter()
        S = self.model_cfg.n_seq
        requests: List[Request] = item_storage.pop_new_items(1 << 30)
        n = len(requests)
        if n == 0:
            return
        cap = max(self.request_capacity or 0, n)
        with phase("queue"):
            # prompt bucket: the next power of two, so a short-prompt queue
            # does not prefill the full n_seq width
            s_pre = prompt_bucket(requests, S)
            prompts_all, plens_all = self._queue(requests, cap, s_pre)
        with phase("upload"):
            prog = self._load(prompts_all, plens_all, n)

        counter.start_record()
        done = False
        prev_status = None
        b_exec = self.engine_cfg.n_slots
        admitted = 0
        while not done:
            with phase("burst_dispatch"):
                for _ in range(self.chunk):
                    self.stats.host_syncs += prog.burst(b_exec)
            self.stats.bursts += self.chunk
            with phase("status_fetch"):
                live, head, free, retry, _fin = prog.status.tolist()
                self.stats.host_syncs += 1
            # admitted requests have their first token on the device: the
            # admitting sub-burst's first round emitted it
            for req in requests[admitted:head]:
                counter.note_first_token(req.id)
            admitted = head
            pending = head < n or retry > 0
            done = live == 0 and not pending
            if not done and not pending:
                # drain: nothing left to admit -- compact live slots to the
                # front and drop to the smallest power-of-two width that
                # still holds them
                while (b_exec // 2 >= self.min_drain_slots
                       and live <= b_exec // 2):
                    prog.compact(b_exec, b_exec // 2)
                    b_exec //= 2
            # a stall needs TWO consecutive no-progress chunks: pages are
            # freed at the start of the NEXT burst
            if live == 0 and pending:
                if (head, free, retry) == prev_status:
                    raise RuntimeError(
                        "autonomous engine stalled: pool exhausted")
                prev_status = (head, free, retry)
            else:
                prev_status = None
        with phase("drain_fetch"):
            # one pull: the outputs, then rows of the device counters
            st = prog.st[self.engine_cfg.n_slots]
            # the int64 counters ride as int32 pairs
            counts = prog.count_vector().view(I32)
            n_halves, width = counts.numel(), S + 1
            rows = -(-n_halves // width)
            counts = torch.cat([counts,
                                counts.new_zeros(rows * width - n_halves)])
            packed = torch.cat([
                torch.cat([st.out_tokens, st.final_lens[:, None]], dim=1),
                counts.view(rows, width)]).cpu().numpy()
            self.stats.host_syncs += 1
            out_tokens, final_lens = packed[:cap, :-1], packed[:cap, -1]
            _fold_counts(self.stats,
                         _int64(packed[cap:].reshape(-1)[:n_halves]))
            self.stats.host_syncs += prog.fold_phases()
        total = 0
        with phase("collect"):
            for i, req in enumerate(requests):
                fl = int(final_lens[i])
                if fl <= 0:
                    raise RuntimeError(f"request {i} unfinished")
                gen = out_tokens[i, plens_all[i]: fl].tolist()
                req.tokens.extend(gen)
                total += len(gen)
                item_storage.add_finished(req)
        counter.add_record_if_recording(total)
        counter.stop_record()


class StreamingSession:
    """Online serving on AutonomousEngine: submit requests at any time,
    step the engine, poll for completions (counterpart of the JAX
    package's StreamingSession). The prompt queue is a device ring buffer
    of ``capacity`` rows: a submission uploads its rows and bumps the
    device request count the burst reads.

    ``capacity`` bounds the requests in flight (submitted and not yet
    collected by ``poll``), not the session's lifetime: a row is reused
    once its occupant has been collected, in submission order.
    ``free_capacity`` says how many submissions are accepted now; ``submit``
    raises beyond it (backpressure: the caller sheds or buffers upstream).

    Greedy decode makes a request's tokens depend only on its prompt and
    the weights, never on when it was submitted or which slot it took: the
    outputs equal the one-shot engine's token for token. Sampled decode
    draws by slot and round, so it is reproducible for a fixed seed and
    submission pattern (as the JAX session's).

    On CUDA the burst is the engine's graph over the session's own buffers
    (captured when the session is made); ``dispatch`` replays it and starts
    the copy of the status and ``final_lens`` into pinned host memory,
    which ``observe`` waits for ``observe_lag`` bursts later.

    Every status read brings the device queue head: a request whose global
    id lies below it has been admitted, and its first token exists on the
    device (the admitting sub-burst's first round emitted it), though
    ``poll`` hands it over only with its last. The session notes a
    request's submit and that read in the global ThroughputCounter
    (``note_submit``, ``note_first_token``): its ``ttfts`` are the waits
    for admission.

        sess = StreamingSession(engine, capacity=4096, max_prompt_len=64)
        sess.submit([Request(0, [1, 2, 3])])
        sess.step()                  # one chunk of bursts
        for req in sess.poll():      # newly finished, tokens filled in
            ...
        sess.close()                 # drain everything still in flight
    """

    def __init__(self, engine: AutonomousEngine, capacity: int,
                 max_prompt_len: int, observe_lag: int = 2):
        S = engine.model_cfg.n_seq
        if not 0 < max_prompt_len < S:
            raise ValueError(f"max_prompt_len {max_prompt_len} not in "
                             f"[1, {S - 1}]")
        self.engine = engine
        self.capacity = capacity
        # pipelined observation (dispatch/observe): completions become
        # visible observe_lag bursts after they happen
        self.observe_lag = max(1, observe_lag)
        # s_pre is the padded buffer width (a power of two, may exceed
        # max_prompt_len); submit() enforces max_prompt_len itself
        self.max_prompt_len = max_prompt_len
        self.s_pre = min(S, 1 << (max_prompt_len - 1).bit_length())
        self._width = engine.engine_cfg.n_slots
        self._prog = engine._program(capacity, self.s_pre, [self._width])
        self.st = self._prog.st[self._width]
        self.stats = BurstStats()
        self._cuda = engine.device.type == "cuda"
        self._pending = collections.deque()
        # pinned staging of uploads still in flight, with their events
        self._staged = []
        self.n_submitted = 0
        self._requests: List[Request] = []
        self._plens: List[int] = []
        self._collected: set = set()
        # every request with global id < _frontier is collected; rows
        # [_frontier % cap, n_submitted % cap) are live and not reusable
        self._frontier = 0
        # every request with global id < _admitted has been seen admitted
        self._admitted = 0

    @property
    def free_capacity(self) -> int:
        """How many requests submit() accepts now (rows whose previous
        occupant has been collected)."""
        return self.capacity - (self.n_submitted - self._frontier)

    def _upload_run(self, rows, lens, row0: int) -> None:
        """One contiguous run of prompt rows and lengths into the queue, and
        their final_lens reset (a recycled row must not look finished).
        On CUDA the rows go from pinned staging without a host wait."""
        k = rows.shape[0]
        rows_t, lens_t = torch.from_numpy(rows), torch.from_numpy(lens)
        if self._cuda:
            rows_t, lens_t = rows_t.pin_memory(), lens_t.pin_memory()
        self._prog.prompts[row0:row0 + k].copy_(rows_t, non_blocking=True)
        self._prog.plens[row0:row0 + k].copy_(lens_t, non_blocking=True)
        self.st.final_lens[row0:row0 + k].zero_()
        if self._cuda:
            done = torch.cuda.Event()
            done.record()
            self._staged.append((done, rows_t, lens_t))

    def submit(self, requests: List[Request]) -> None:
        """Enqueue requests. Raises ValueError beyond free_capacity (the
        backpressure contract) or for a prompt longer than
        max_prompt_len."""
        if not requests:
            return
        with phase("submit"):
            self._submit(requests)

    def _submit(self, requests: List[Request]) -> None:
        k = len(requests)
        if k > self.free_capacity:
            raise ValueError(
                f"backpressure: {k} submissions > free_capacity="
                f"{self.free_capacity} (capacity {self.capacity}, "
                f"{self.n_submitted - self._frontier} in flight or "
                "uncollected); poll() to collect completions or shed load "
                "upstream")
        rows = np.zeros((k, self.s_pre), np.int32)
        lens = np.zeros((k,), np.int32)
        for i, req in enumerate(requests):
            if not 0 < len(req.tokens) <= self.max_prompt_len:
                raise ValueError(f"prompt length {len(req.tokens)} not in "
                                 f"[1, max_prompt_len="
                                 f"{self.max_prompt_len}]")
            rows[i, : len(req.tokens)] = req.tokens
            lens[i] = len(req.tokens)
        counter = get_global_throughput_counter()
        for req in requests:
            counter.note_submit(req.id)
        self._staged = [s for s in self._staged if not s[0].query()]
        row0 = self.n_submitted % self.capacity
        first = min(k, self.capacity - row0)   # split a wrap-around
        self._upload_run(rows[:first], lens[:first], row0)
        if first < k:
            self._upload_run(rows[first:], lens[first:], 0)
        self.n_submitted += k
        self._prog.n_real.fill_(self.n_submitted)
        self._requests.extend(requests)
        self._plens.extend(int(x) for x in lens)

    def _burst(self) -> None:
        self.stats.host_syncs += self._prog.burst(self._width)
        self.stats.bursts += 1

    def _seen(self, head: int) -> None:
        """A read has just shown the requests below ``head`` admitted:
        their first tokens exist on the device."""
        counter = get_global_throughput_counter()
        for g in range(self._admitted, head):
            counter.note_first_token(self._requests[g].id)
        self._admitted = max(self._admitted, head)

    def _status_dict(self, snap: np.ndarray, n_submitted_at: int) -> dict:
        live, head, free, retry, fin = (int(x) for x in snap[:5])
        return {"live": live, "queued": self.n_submitted - head + retry,
                "free_groups": free, "finished_total": fin,
                "fin_lens": snap[5:], "n_submitted_at": n_submitted_at}

    def step(self, n_bursts: int | None = None,
             observe: bool = False) -> dict:
        """Run one chunk of bursts (default: the engine's
        bursts_per_chunk) and read the status: {live, queued, free_groups,
        finished_total}. ``observe=True`` brings the final_lens snapshot in
        the same read (``fin_lens`` and ``n_submitted_at``, both for
        poll())."""
        with phase("burst_dispatch"):
            for _ in range(n_bursts or self.engine.chunk):
                self._burst()
        with phase("status_fetch"):
            snap = (torch.cat([self._prog.status, self.st.final_lens])
                    if observe else self._prog.status).cpu().numpy()
            self.stats.host_syncs += 1
        self._seen(int(snap[1]))
        out = self._status_dict(snap, self.n_submitted)
        if not observe:
            del out["fin_lens"], out["n_submitted_at"]
        return out

    def dispatch(self) -> None:
        """Pipelined serving: one burst, and the copy of its status and
        final_lens to the host started without waiting (on CUDA, into
        pinned memory behind an event); observe() reads it later.
        n_submitted rides along: a row recycled after this snapshot may
        still show its previous occupant's final length in it, so polls
        against it ignore later submissions."""
        with phase("burst_dispatch"):
            self._burst()
            snap = torch.cat([self._prog.status, self.st.final_lens])
            if self._cuda:
                host = torch.empty(snap.shape, dtype=snap.dtype,
                                   pin_memory=True)
                host.copy_(snap, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host, done = snap, None
        self._pending.append((host, done, self.n_submitted))

    def observe(self, block: bool = False) -> dict | None:
        """The oldest in-flight burst's status, once it is at least
        observe_lag bursts old (or at once with ``block``): the step() dict
        plus ``fin_lens`` (that burst's final_lens snapshot) and
        ``n_submitted_at``; None if there is none yet."""
        if not self._pending or (
                len(self._pending) <= self.observe_lag and not block):
            return None
        host, done, n_sub = self._pending.popleft()
        with phase("status_fetch"):
            if done is not None:
                done.synchronize()
                self.stats.host_syncs += 1
            snap = host.numpy()
        self._seen(int(snap[1]))
        return self._status_dict(snap, n_sub)

    def poll(self, fin_lens: np.ndarray | None = None,
             n_submitted_at: int | None = None) -> List[Request]:
        """Finished requests (tokens appended), each returned once.
        ``fin_lens``: an observe() or step(observe=True) snapshot to use
        instead of reading the latest final_lens (completions only grow,
        and a finished row holds its tokens until it is recycled, so the
        latest out_tokens rows of snapshot-finished requests are exact)."""
        if fin_lens is None:
            with phase("poll_fetch"):
                fl = self.st.final_lens.cpu().numpy()
                self.stats.host_syncs += 1
            hi = self.n_submitted
        else:
            fl = fin_lens
            hi = min(self.n_submitted, self.n_submitted
                     if n_submitted_at is None else n_submitted_at)
        new = [g for g in range(self._frontier, hi)
               if g not in self._collected and fl[g % self.capacity] > 0]
        if not new:
            return []
        # a finished request was admitted, and so was every earlier one
        self._seen(new[-1] + 1)
        with phase("poll_fetch"):
            idx = torch.tensor([g % self.capacity for g in new],
                               device=self.st.out_tokens.device)
            rows = self.st.out_tokens.index_select(0, idx).cpu().numpy()
            self.stats.host_syncs += 2
        out = []
        with phase("collect"):
            for j, g in enumerate(new):
                req = self._requests[g]
                row_fl = int(fl[g % self.capacity])
                req.tokens.extend(rows[j, self._plens[g]: row_fl].tolist())
                self._collected.add(g)
                out.append(req)
            while self._frontier in self._collected:
                self._collected.discard(self._frontier)
                self._frontier += 1
        return out

    def close(self) -> List[Request]:
        """Run until every submitted request finishes; returns the
        remaining completions (as poll). Raises if the pool can never admit
        what is queued (two chunks in a row without progress). The
        session's device counters then go to ``stats`` and the kernel
        wrappers' launch counts."""
        prev = None
        out = []
        # what the pipelined path already has in flight, then fresh steps
        while self._pending:
            s = self.observe(block=True)
            out.extend(self.poll(s["fin_lens"], s["n_submitted_at"]))
        while True:
            s = self.step()
            out.extend(self.poll())
            if s["live"] == 0 and s["queued"] == 0:
                break
            if s["live"] == 0 and s["queued"] > 0:
                key = (s["queued"], s["free_groups"])
                if key == prev:
                    raise RuntimeError("streaming session stalled: "
                                       "pool exhausted")
                prev = key
            else:
                prev = None
        out.extend(self.poll())
        self._fold_device_counts()
        return out

    def _fold_device_counts(self) -> None:
        """The session's device counters so far into ``stats`` (the
        preemptions in full) and the kernel wrappers' launch counts."""
        counts = self._prog.count_vector().cpu().numpy()
        self._prog.counts.zero_()
        self.stats.host_syncs += 1
        self.stats.preemptions = 0
        _fold_counts(self.stats, counts)
        self.stats.host_syncs += self._prog.fold_phases()
