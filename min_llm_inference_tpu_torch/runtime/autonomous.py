"""Device-resident continuous batching: the scheduler runs on the device.

Counterpart of min_llm_inference_tpu/runtime/autonomous.py. The request
queue (padded prompts + lengths) is uploaded once; each burst frees dead
slots' pages (vectorized stack push), admits queue-head requests into dead
slots (vectorized stack pop), prefills them, runs n_forward_rounds of
greedy decode and scatters the tokens into a device-resident output
buffer. The host reads a 5-int status once per chunk of bursts and the
outputs once at the end.

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

Host reads inside a burst (each one scalar): the whole-burst liveness gate
(JAX: ``lax.cond``) and, per sub-burst, the admitted count that picks the
prefill bucket (JAX: ``lax.switch``). Nothing else in a burst syncs (the
ring, its flush, the sort and the overcommit scheduler included);
``BurstStats.host_syncs`` counts every sync of a run.

Not ported yet (raise NotImplementedError): sampling and StreamingSession.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch

from ..config import EngineConfig, ModelConfig, resolve_device
from ..metrics import get_global_throughput_counter
from ..models.model import DEFAULT_CTX, decode_round_tokens, prefill_write_kv
from ..models.paged import (
    PagedKVState,
    init_paged_state,
    make_prefill_kv_writer,
    make_ring_round_callbacks,
    make_round_kv_callbacks,
    pack_ring_for_flush,
    ring_pad_rows,
)
from ..models.params import fuse_qkv_params
from ..ops.indexing import index_set_drop_
from ..ops.ring_flush import ring_flush
from ..utils.profiling import phase
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
    that admitted), host syncs (the host waiting on the device: scalar and
    output reads, and the run's two input uploads) and, under overcommit,
    preemptions (read with the final outputs)."""

    bursts: int = 0
    skipped: int = 0
    rounds: int = 0
    prefills: int = 0
    host_syncs: int = 0
    preemptions: int = 0


def _check_supported(engine_cfg: EngineConfig, attention_impl: str) -> None:
    if attention_impl not in ("grouped", "torch"):
        raise ValueError(f"unknown attention_impl {attention_impl!r}")


def init_auto_state(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                    n_requests: int, device=None) -> AutoState:
    """The free list holds unit ids and a slot's page-table row is made of
    contiguous units: one W-page group under full grant, two W/2-page
    halves under overcommit (an ungrown slot's second half repeats its
    first). ``device``: ``cuda`` unless the caller names another (raises
    without a GPU)."""
    dev = resolve_device(device)
    B = engine_cfg.n_slots
    W = engine_cfg.pages_per_slot(model_cfg.n_seq)
    oc = engine_cfg.overcommit
    NG = engine_cfg.n_pages // (W // 2 if oc else W)

    def zeros(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return AutoState(
        kv=init_paged_state(model_cfg, engine_cfg, dev),
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
                          n_real: int) -> Admission:
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
                          n_real: int) -> Admission:
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


def _new_rings(model_cfg: ModelConfig, engine_cfg: EngineConfig, dev,
               n_rounds: int):
    """Zeroed per-layer rings [B, R_pad, 2*D] (int4 rows ride unpacked,
    one int8 per feature) and, for quantized pools, [B, 128] f32 scale
    columns."""
    B = engine_cfg.n_slots
    shape = (B, ring_pad_rows(n_rounds), 2 * model_cfg.emb_dim)
    L = model_cfg.n_layers
    rings = [torch.zeros(shape, dtype=engine_cfg.kv_torch_dtype, device=dev)
             for _ in range(L)]
    scs = ([torch.zeros((B, 128), dtype=torch.float32, device=dev)
            for _ in range(L)] if engine_cfg.kv_quantized else [None] * L)
    return rings, scs


def _sub_burst(model_cfg: ModelConfig, engine_cfg: EngineConfig,
               attention_impl: str, max_new: int, ctx, R: int,
               round_offset: int, ring_ctx, do_flush: bool,
               stats: BurstStats, params, st: AutoState, prompts_all,
               plens_all, n_real: int):
    """One admit -> prefill -> R decode rounds. ``ring_ctx`` (rings, scale
    columns, ring_start, ring_r0) is the burst-wide ring threaded across
    sub-bursts, or None (a fresh ring per sub-burst when ring decode is on);
    ``round_offset`` is the absolute round of this sub-burst's first round
    and ``do_flush`` lands the ring in the pages at its end. Returns (state,
    status, ring_ctx)."""
    dev = st.lengths.device
    NP = engine_cfg.n_pages
    P = engine_cfg.page_size
    S = model_cfg.n_seq
    R_total, S_pre = prompts_all.shape

    # ---- 1-2. free, (overcommit: grow, preempt,) admit ----
    if engine_cfg.overcommit:
        adm = _overcommit_admission(engine_cfg, max_new, R, st, prompts_all,
                                    plens_all, n_real)
    else:
        adm = _full_grant_admission(engine_cfg, max_new, st, prompts_all,
                                    plens_all, n_real)
    (page_table, lengths, last_tokens, rid, allocated, queue_head, free_top,
     page_stack, granted, plens, prompts, m, slot_ids, oc) = adm

    # ---- 3. prefill the admitted prompts over the smallest bucket of rows
    # that holds them (the first m rows of the max_new block) ----
    kv = st.kv
    heads = ctx.local_heads(model_cfg)
    sizes = [s for s in (64, 128, 256) if s < max_new] + [max_new]
    n_adm = int(m)
    stats.host_syncs += 1
    bs = next((s for s in sizes if n_adm <= s), None) if n_adm else None
    if bs is not None:
        write_kv_block, _ = make_prefill_kv_writer(
            kv, granted[:bs], plens[:bs], S_pre, P, NP, n_heads=heads)
        prefill_write_kv(params, model_cfg, prompts[:bs], plens[:bs],
                         write_kv_block, ctx)
        stats.prefills += 1

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
        rings, ring_scs = _new_rings(model_cfg, engine_cfg, dev, R)
        ring_start = torch.clamp_min(lengths - 1, 0)
        ring_r0 = None
        flush_rounds = R
        col_base = 0
    kv_pages, k_scales, v_scales = (list(kv.kv_pages), list(kv.k_scales),
                                    list(kv.v_scales))
    row = rid % R_total
    toks, out_idx, fin_rid, fin_len = [], [], [], []
    for r in range(R):
        live = lengths > 0
        if use_ring:
            write_kv, attend = make_ring_round_callbacks(
                model_cfg, engine_cfg, page_table, kv_pages, k_scales,
                v_scales, rings, ring_scs, lengths, ring_start, col_base + r,
                ring_r0=ring_r0, n_heads=heads)
        else:
            write_kv, attend = make_round_kv_callbacks(
                model_cfg, engine_cfg, attention_impl, page_table,
                kv_pages, k_scales, v_scales, lengths, n_heads=heads)
        tok, new_lengths = decode_round_tokens(
            params, model_cfg, lengths, last_tokens, write_kv, attend, ctx)
        # the emitted token's position in its sequence is the old length
        toks.append(tok)
        out_idx.append(torch.where(live, row * S + lengths, R_total * S))
        fin_rid.append(torch.where(live & (new_lengths == 0), row, R_total))
        fin_len.append(lengths + 1)
        last_tokens = torch.where(live, tok, last_tokens)
        lengths = new_lengths
    stats.rounds += R
    if use_ring and do_flush:
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
                       st.final_lens, **oc)
    ring_ctx_out = (None if ring_ctx is None
                    else (rings, ring_scs, ring_start, ring_r0))
    return new_st, _status_of(new_st), ring_ctx_out


def _autonomous_burst(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                      attention_impl: str, max_new: int, ctx,
                      stats: BurstStats, params, st: AutoState, prompts_all,
                      plens_all, n_real: int):
    """One burst: ``subbursts`` repetitions of admit -> prefill -> decode
    (n_forward_rounds / subbursts rounds each), so dead slots refill every
    R/subbursts rounds while the host pays one status read per chunk. One
    liveness gate covers the whole burst: with no live slot and nothing
    queued the burst costs one scalar read and changes nothing.

    With ring decode, ``burst_flush`` and ``subbursts > 1``, one ring sized
    for the whole burst rides across the sub-bursts and is flushed once at
    burst end; otherwise each sub-burst flushes its own ring."""
    stats.bursts += 1
    pending = st.queue_head < n_real
    if engine_cfg.overcommit:
        pending = pending | (st.retry_top > 0)
    go = bool(((st.lengths > 0).any() | pending).item())
    stats.host_syncs += 1
    if not go:
        stats.skipped += 1
        return st, _status_of(st)
    n_sub = engine_cfg.subbursts
    r_sub = engine_cfg.n_forward_rounds // n_sub
    use_ring = engine_cfg.decode_ring and attention_impl == "grouped"
    burst_ring = use_ring and engine_cfg.burst_flush and n_sub > 1
    ring_ctx = None
    if burst_ring:
        rings, ring_scs = _new_rings(model_cfg, engine_cfg, st.lengths.device,
                                     engine_cfg.n_forward_rounds)
        # slots live at burst start: first new position = length - 1,
        # first ring column 0; admissions overwrite their entries
        ring_ctx = (rings, ring_scs, torch.clamp_min(st.lengths - 1, 0),
                    torch.zeros_like(st.lengths))
    status = None
    for k in range(n_sub):
        st, status, ring_ctx = _sub_burst(
            model_cfg, engine_cfg, attention_impl, max_new, ctx, r_sub,
            k * r_sub, ring_ctx, (not burst_ring) or k == n_sub - 1,
            stats, params, st, prompts_all, plens_all, n_real,
        )
    return st, status


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


class AutonomousEngine:
    """Continuous-batching engine with the scheduler on the device.

    ``attention_impl``: ``"grouped"`` (the CUDA kernels: the fused-write
    kernel, or with ``decode_ring`` the ring partial of the configured
    formulation; their plain versions on the CPU) or ``"torch"`` (scatter +
    the gather oracle, no ring). ``device``: ``cuda`` unless the caller
    names another; raises without a GPU. ``params`` are tensors on that
    device (models.params_from_numpy).
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
        device=None,
    ):
        model_cfg.validate()
        engine_cfg.validate(model_cfg)
        _check_supported(engine_cfg, attention_impl)
        if temperature > 0:
            raise NotImplementedError("sampling is not ported yet")
        self.device = resolve_device(device)
        if params["wte"].device.type != self.device.type:
            raise ValueError(f"params are on {params['wte'].device}, the "
                             f"engine runs on {self.device}")
        self.params = fuse_qkv_params(params)
        self.model_cfg = model_cfg
        self.engine_cfg = engine_cfg
        self.max_new = min(max_new_per_burst, engine_cfg.n_slots)
        self.chunk = bursts_per_chunk
        self.request_capacity = request_capacity
        self.attention_impl = attention_impl
        # drain downshift floor; n_slots = disabled
        self.min_drain_slots = (max(8, min_drain_slots) if min_drain_slots
                                else engine_cfg.n_slots)
        self.stats = BurstStats()

    def _burst_for(self, b_exec: int):
        """The burst over the first b_exec slots (drain downshift: once the
        queue is empty and liveness has fallen, projections, logits and the
        kernel grid run over b_exec rows)."""
        cfg = (self.engine_cfg if b_exec == self.engine_cfg.n_slots
               else dataclasses.replace(self.engine_cfg, n_slots=b_exec))
        max_new = min(self.max_new, b_exec)

        def burst(st, prompts_all, plens_all, n_real):
            return _autonomous_burst(
                self.model_cfg, cfg, self.attention_impl, max_new,
                DEFAULT_CTX, self.stats, self.params, st, prompts_all,
                plens_all, n_real)

        return burst

    def run(self, item_storage: ItemStorage) -> None:
        counter = get_global_throughput_counter()
        S = self.model_cfg.n_seq
        requests: List[Request] = item_storage.pop_new_items(1 << 30)
        n = len(requests)
        if n == 0:
            return
        cap = max(self.request_capacity or 0, n)
        max_plen = max(len(r.tokens) for r in requests)
        # prompt bucket: the next power of two, so a short-prompt queue does
        # not prefill the full n_seq width
        s_pre = min(S, 1 << (max_plen - 1).bit_length())
        prompts_all = np.zeros((cap, s_pre), dtype=np.int32)
        plens_all = np.zeros(cap, dtype=np.int32)
        for i, req in enumerate(requests):
            if not 0 < len(req.tokens) < S:
                raise ValueError(f"request {req.id}: prompt length "
                                 f"{len(req.tokens)} not in [1, {S - 1}]")
            prompts_all[i, : len(req.tokens)] = req.tokens
            plens_all[i] = len(req.tokens)

        st = init_auto_state(self.model_cfg, self.engine_cfg, cap,
                             self.device)
        prompts_dev = torch.from_numpy(prompts_all).to(self.device)
        plens_dev = torch.from_numpy(plens_all).to(self.device)
        self.stats.host_syncs += 2  # blocking uploads (pageable memory)

        counter.start_record()
        done = False
        prev_status = None
        b_exec = self.engine_cfg.n_slots
        while not done:
            burst = self._burst_for(b_exec)
            with phase("burst_dispatch"):
                for _ in range(self.chunk):
                    st, status = burst(st, prompts_dev, plens_dev, n)
            with phase("status_fetch"):
                live, head, free, retry, _fin = status.tolist()
                self.stats.host_syncs += 1
            pending = head < n or retry > 0
            done = live == 0 and not pending
            if not done and not pending:
                # drain: nothing left to admit -- compact live slots to the
                # front and drop to the smallest power-of-two width that
                # still holds them
                while (b_exec // 2 >= self.min_drain_slots
                       and live <= b_exec // 2):
                    b_exec //= 2
                    st = _compact_slice(st, b_exec)
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
            packed = torch.cat([st.out_tokens, st.final_lens[:, None]], dim=1)
            if st.preempted is not None:
                # the preemption count rides in one more row of the pull
                extra = torch.cat([st.preempted.view(1, 1),
                                   torch.zeros_like(packed[:1, 1:])], dim=1)
                packed = torch.cat([packed, extra])
            packed = packed.cpu().numpy()
            self.stats.host_syncs += 1
            if st.preempted is not None:
                self.stats.preemptions += int(packed[-1, 0])
                packed = packed[:-1]
            out_tokens, final_lens = packed[:, :-1], packed[:, -1]
        total = 0
        for i, req in enumerate(requests):
            fl = int(final_lens[i])
            if fl <= 0:
                raise RuntimeError(f"request {i} unfinished")
            gen = out_tokens[i, plens_all[i]: fl].tolist()
            req.tokens.extend(gen)
            total += len(gen)
            counter.note_first_token(req.id)
            item_storage.add_finished(req)
        counter.add_record_if_recording(total)
        counter.stop_record()


class StreamingSession:
    """The streaming front end of AutonomousEngine (submit / step / poll /
    close). Not ported yet: it waits for a later slice of the port."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("StreamingSession is not ported yet")
