"""Continuous-batching engine loops with the scheduler on the host.

Counterpart of min_llm_inference_tpu/runtime/engine.py, the reference's L5
inferencer loop (forward / process results / page realloc / insert per
iteration). Per iteration only small int32 arrays cross the host <-> device
boundary: one packed scheduler upload (and the compact prompts when slots
were admitted) and one results pull; the KV pools live on the device.

Backends, the reference's three engine entry points (the JAX package's
``attention_impl`` names in brackets):
  * DenseEngine                            <- start_inference_engine
  * PagedEngine(attention_impl="torch")    <- start_paged_attention_...
    [``jnp``]
  * PagedEngine(attention_impl="paged")    <- the cuBLAS backend [``pallas``]:
    the one-slot CUDA kernel (ops/paged_attention.py)
  * PagedEngine(attention_impl="grouped"): the fused-write CUDA kernel
  * NativePagedEngine: PagedEngine's loop with the C++ host scheduler.

Every engine runs on ``cuda`` unless the caller passes ``device``; without
a GPU it raises. ``params`` are tensors on that device
(models.params_from_numpy).

Transfers on CUDA never stall the stream: uploads go through a fresh pinned
copy (PyTorch's caching host allocator holds the block until its copy has
run) and are enqueued with ``non_blocking``; the paged engines pull each
burst's [B, R] results into one of two alternating pinned buffers right
after the burst is dispatched and wait on that copy's event one iteration
later, while the next burst runs. That wait is the loop's one host sync
per iteration (``EngineStats.host_syncs``).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..config import (
    EngineConfig,
    ModelConfig,
    refuse_latent,
    resolve_device,
)
from ..metrics import get_global_throughput_counter
from ..models.dense import init_dense_state, make_dense_fns
from ..models.model import DEFAULT_CTX
from ..models.paged import init_paged_state, make_paged_fns
from ..models.params import fuse_qkv_params, params_device
from ..utils.profiling import phase
from .item_storage import (
    ItemStorage,
    ProcessingStorage,
    Request,
    insert_new_items_dense,
    is_done,
    process_decoder_result,
)
from .paged_scheduler import (
    PagePool,
    PageTable,
    allocate_or_free_pages,
    insert_new_items_paged,
)


@dataclasses.dataclass
class EngineStats:
    """What a host engine did in its last run: bursts dispatched (one
    decode_rounds call each), decode rounds, prefill blocks, slots
    preempted, host->device uploads, and host syncs (the host waiting on
    the device: one results pull per burst)."""

    bursts: int = 0
    rounds: int = 0
    prefills: int = 0
    preemptions: int = 0
    uploads: int = 0
    host_syncs: int = 0


class _EngineBase:
    def __init__(self, params, model_cfg: ModelConfig,
                 engine_cfg: EngineConfig, device=None):
        refuse_latent(model_cfg, type(self).__name__)
        model_cfg.validate()
        engine_cfg.validate(model_cfg)
        self.device = resolve_device(device)
        if params_device(params).type != self.device.type:
            raise ValueError(f"params are on {params_device(params)}, the "
                             f"engine runs on {self.device}")
        self.params = fuse_qkv_params(params)
        self.model_cfg = model_cfg
        self.engine_cfg = engine_cfg
        B, S = engine_cfg.n_slots, model_cfg.n_seq
        self.prompts = np.zeros((B, S), dtype=np.int32)
        self.lengths = np.zeros(B, dtype=np.int32)
        self.last_tokens = np.zeros(B, dtype=np.int32)
        self.stats = EngineStats()
        self._pull_bufs = [None, None]
        self._pull_ix = 0

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host int32 staging array -> device tensor without a host sync;
        ``arr`` may be rewritten as soon as this returns."""
        self.stats.uploads += 1
        t = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _start_pull(self, results):
        """Enqueue the device->host copy of one burst's results behind it.
        Returns the ticket ``_finish_pull`` waits on."""
        if self.device.type != "cuda":
            return results
        i, self._pull_ix = self._pull_ix, self._pull_ix ^ 1
        buf = self._pull_bufs[i]
        if buf is None or buf.shape != results.shape:
            buf = torch.empty(results.shape, dtype=results.dtype,
                              pin_memory=True)
            self._pull_bufs[i] = buf
        buf.copy_(results, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return buf, done

    def _finish_pull(self, ticket) -> np.ndarray:
        """The loop's host sync: wait for a pulled burst, return its
        results as a numpy array of its own (the pinned buffer is reused
        two bursts later)."""
        self.stats.host_syncs += 1
        if isinstance(ticket, torch.Tensor):
            return ticket.numpy()
        buf, done = ticket
        done.synchronize()
        return buf.numpy().copy()

    def _run_prefill(self, new_slots: List[int]) -> None:
        """Compact prefill over the newly admitted slots, in buckets of
        max_prefill_batch rows (padding rows have length 0). Prompts,
        lengths and the slots' rows go up as one upload per bucket."""
        M = self.engine_cfg.max_prefill_batch
        S = self.model_cfg.n_seq
        for i in range(0, len(new_slots), M):
            chunk = new_slots[i: i + M]
            slot_arg = self._prefill_slot_arg(chunk, M)
            block = np.zeros((M, S + 1 + slot_arg.shape[1]), dtype=np.int32)
            for j, slot in enumerate(chunk):
                block[j, :S] = self.prompts[slot]
                block[j, S] = self.lengths[slot]
            block[:, S + 1:] = slot_arg
            dev = self._upload(block)
            self.state = self._prefill(self.params, self.state, dev[:, :S],
                                       dev[:, S], dev[:, S + 1:])
            self.stats.prefills += 1


class DenseEngine(_EngineBase):
    """Contiguous-KV continuous batching (reference src/inferencer.cpp:
    11-41): a synchronous loop (one pull of lengths, last tokens and
    results per iteration). Rejects quantized KV: without page scales the
    dense caches would hold raw truncated integers. Runs no kernel."""

    def __init__(self, params, model_cfg: ModelConfig,
                 engine_cfg: EngineConfig, device=None):
        super().__init__(params, model_cfg, engine_cfg, device)
        if engine_cfg.kv_quantized:
            raise ValueError(
                f"DenseEngine does not support kv_dtype="
                f"{engine_cfg.kv_dtype!r}: quantized KV requires per-page "
                "scales (use a paged engine)")
        self.state = init_dense_state(model_cfg, engine_cfg, self.device)
        self._prefill, self._decode = make_dense_fns(model_cfg, engine_cfg)

    def _prefill_slot_arg(self, chunk: List[int], M: int) -> np.ndarray:
        # padding rows point one past the end so the scatter drops them
        slot_ids = np.full((M, 1), self.engine_cfg.n_slots, dtype=np.int32)
        slot_ids[: len(chunk), 0] = chunk
        return slot_ids

    def run(self, item_storage: ItemStorage) -> None:
        processing = ProcessingStorage()
        counter = get_global_throughput_counter()
        B = self.engine_cfg.n_slots
        R = self.engine_cfg.n_forward_rounds
        self.stats = EngineStats()
        new_slots = insert_new_items_dense(
            list(range(B)), self.prompts, self.lengths, self.last_tokens,
            item_storage, processing,
        )
        counter.start_record()
        while not is_done(item_storage, processing):
            if new_slots:
                with phase("prefill"):
                    self._run_prefill(new_slots)
            with phase("forward"):
                up = self._upload(np.stack([self.lengths, self.last_tokens]))
                self.state, lengths_dev, last_dev, results_dev = self._decode(
                    self.params, self.state, up[0], up[1])
                self.stats.bursts += 1
                self.stats.rounds += R
            with phase("process_results"):
                pulled = self._finish_pull(self._start_pull(torch.cat(
                    [lengths_dev[:, None], last_dev[:, None], results_dev],
                    dim=1)))
                self.lengths = pulled[:, 0].copy()
                self.last_tokens = pulled[:, 1].copy()
                finished = process_decoder_result(
                    pulled[:, 2:], item_storage, processing,
                    self.model_cfg.n_seq, self.model_cfg.eof_token_id,
                )
            with phase("insert"):
                new_slots = insert_new_items_dense(
                    finished, self.prompts, self.lengths, self.last_tokens,
                    item_storage, processing,
                )
        counter.stop_record()


class _PagedLoop(_EngineBase):
    """The two-deep pipelined loop shared by PagedEngine and
    NativePagedEngine: burst k is dispatched before burst k-1's results are
    pulled, so the pull and all host scheduling overlap burst k on the
    device. Sound because the device zeroes a slot's length at EOF / the
    n_seq cap itself, the host only injects state (admissions and
    preemptions ride the packed operand's update column), page growth looks
    two bursts ahead, and greedy decode is deterministic, so dropping a
    preempted slot's in-flight tokens and recomputing them is exact."""

    def __init__(self, params, model_cfg: ModelConfig,
                 engine_cfg: EngineConfig, attention_impl: str, device,
                 ctx=DEFAULT_CTX):
        super().__init__(params, model_cfg, engine_cfg, device)
        self.attention_impl = attention_impl
        self._prefill, self._decode = make_paged_fns(
            model_cfg, engine_cfg, attention_impl, ctx=ctx)
        self.state = init_paged_state(model_cfg, engine_cfg, self.device,
                                      tp=ctx.tp)
        W = engine_cfg.pages_per_slot(model_cfg.n_seq)
        self.W = W
        # the host page table [n_slots, W], written in place by the
        # scheduler (PageTable or the native one)
        self.table = np.zeros((engine_cfg.n_slots, W), dtype=np.int32)
        # packed scheduler operand: col 0 length update (-1 = keep), col 1
        # last-token update, cols 2: the page table
        self._packed = np.zeros((engine_cfg.n_slots, 2 + W), dtype=np.int32)
        self.lookahead = 2 * engine_cfg.n_forward_rounds

    def _prefill_slot_arg(self, chunk: List[int], M: int) -> np.ndarray:
        rows = np.zeros((M, self.W), dtype=np.int32)
        for j, slot in enumerate(chunk):
            rows[j] = self.table[slot]
        return rows

    def _pack(self, new_slots, preempted) -> None:
        self._packed[:, 0] = -1
        for slot in preempted:
            self._packed[slot, 0] = 0
        for slot in new_slots:
            self._packed[slot, 0] = self.lengths[slot]
            self._packed[slot, 1] = self.last_tokens[slot]
        self._packed[:, 2:] = self.table

    def _dispatch(self, lengths_dev, last_dev):
        """One burst on the device, its results' pull enqueued behind it."""
        with phase("forward"):
            self.state, lengths_dev, last_dev, results_dev = self._decode(
                self.params, self.state, self._upload(self._packed),
                lengths_dev, last_dev)
            ticket = self._start_pull(results_dev)
        self._packed[:, 0] = -1  # consumed
        self.stats.bursts += 1
        self.stats.rounds += self.engine_cfg.n_forward_rounds
        return lengths_dev, last_dev, ticket


class PagedEngine(_PagedLoop):
    """Paged-KV continuous batching with admission control, on-demand page
    growth and recompute-on-preempt (reference src/inferencer.cpp:43-133),
    two-deep pipelined. ``attention_impl``: ``"paged"`` (the one-slot CUDA
    kernel; float32/int8 KV), ``"grouped"`` (the fused-write CUDA kernel)
    or ``"torch"`` (scatter + the gather oracle); on CPU tensors the
    kernels' wrappers run their plain versions. ``ctx``: the parallel
    context; a mesh rank (parallel/engine.py) passes its TpShardCtx with
    its local params and its dp group's config."""

    def __init__(self, params, model_cfg: ModelConfig,
                 engine_cfg: EngineConfig, attention_impl: str = "torch",
                 device=None, ctx=DEFAULT_CTX):
        super().__init__(params, model_cfg, engine_cfg, attention_impl,
                         device, ctx)
        self.pool = PagePool(engine_cfg.n_pages)
        self.page_table = PageTable(engine_cfg.n_slots, self.W)
        self.table = self.page_table.table  # written in place by PageTable

    def _insert(self, item_storage: ItemStorage, processing):
        return insert_new_items_paged(
            self.prompts, self.lengths, self.last_tokens,
            item_storage, processing, self.pool, self.page_table,
            self.engine_cfg.n_forward_rounds, self.engine_cfg.page_size,
            self.engine_cfg.init_num_pages, self.lookahead,
        )

    def _schedule(self, item_storage, processing, finished):
        """Page realloc + admission; packs the operand of the NEXT
        dispatch. Returns the newly admitted slots."""
        preempted = allocate_or_free_pages(
            self.page_table, self.pool, processing, item_storage,
            finished, self.engine_cfg.n_forward_rounds,
            self.engine_cfg.page_size, self.lookahead,
        )
        self.stats.preemptions += len(preempted)
        new_slots = self._insert(item_storage, processing)
        self._pack(new_slots, preempted)
        return new_slots

    def run(self, item_storage: ItemStorage) -> None:
        processing = ProcessingStorage()
        counter = get_global_throughput_counter()
        B = self.engine_cfg.n_slots
        self.stats = EngineStats()

        # initial schedule: admissions into an all-dead device state
        new_slots = self._insert(item_storage, processing)
        self._packed[:, 0] = 0  # every slot starts dead...
        self._packed[:, 1] = 0
        for slot in new_slots:
            self._packed[slot, 0] = self.lengths[slot]
            self._packed[slot, 1] = self.last_tokens[slot]
        self._packed[:, 2:] = self.table
        skip_slots = set()  # the first burst runs after prefill
        if new_slots:
            self._run_prefill(new_slots)
        lengths_dev = torch.zeros(B, dtype=torch.int32, device=self.device)
        last_dev = torch.zeros(B, dtype=torch.int32, device=self.device)

        counter.start_record()
        pending = None
        while True:
            dispatched = processing.size() > 0
            if dispatched:
                lengths_dev, last_dev, ticket = self._dispatch(lengths_dev,
                                                               last_dev)
            if pending is not None:
                with phase("process_results"):
                    results = self._finish_pull(pending)  # the one sync
                    finished = process_decoder_result(
                        results, item_storage, processing,
                        self.model_cfg.n_seq, self.model_cfg.eof_token_id,
                        skip_slots=skip_slots, pipelined=True,
                    )
                    # host mirror for staging/scheduling
                    for slot in processing.slots():
                        req = processing.get(slot)
                        self.lengths[slot] = len(req.tokens)
                        self.last_tokens[slot] = req.tokens[-1]
                with phase("schedule"):
                    new_slots = self._schedule(item_storage, processing,
                                               finished)
                skip_slots = set(new_slots)
                if new_slots:
                    # enqueued after the in-flight burst; runs before the
                    # next dispatch reads these pages
                    with phase("prefill"):
                        self._run_prefill(new_slots)
            if not dispatched:
                if is_done(item_storage, processing):
                    break
                # nothing in flight but work queued (everything preempted):
                # loop to re-dispatch after scheduling
                pending = None
                continue
            pending = ticket
        counter.stop_record()


class NativePagedEngine(_PagedLoop):
    """PagedEngine with the host scheduler in native C++
    (csrc/scheduler.cpp through runtime/native.py, built from the port's
    own copy at first use). Same two-deep pipelined loop and packed
    operand; all queue/page/result bookkeeping runs natively and writes the
    staging arrays in place. Raises where no C++ compiler can build the
    scheduler; it never becomes PagedEngine. ``ctx`` as PagedEngine's."""

    def __init__(self, params, model_cfg: ModelConfig,
                 engine_cfg: EngineConfig, attention_impl: str = "torch",
                 device=None, ctx=DEFAULT_CTX):
        from .native import NativeScheduler

        super().__init__(params, model_cfg, engine_cfg, attention_impl,
                         device, ctx)
        self.sched = NativeScheduler(
            engine_cfg.n_slots, model_cfg.n_seq, engine_cfg.n_pages,
            self.W, engine_cfg.page_size, engine_cfg.init_num_pages,
            engine_cfg.n_forward_rounds, model_cfg.eof_token_id,
            lookahead=self.lookahead,
        )

    def run(self, item_storage: ItemStorage) -> None:
        counter = get_global_throughput_counter()
        sched = self.sched
        B = self.engine_cfg.n_slots
        self.stats = EngineStats()
        # hand the queue to the native scheduler
        for req in item_storage.pop_new_items(1 << 30):
            counter.note_submit(req.id)
            sched.add_request(req.id, req.tokens)

        new_slots = sched.insert_new(
            self.prompts, self.lengths, self.last_tokens, self.table)
        self._pack(new_slots, [])
        if new_slots:
            self._run_prefill(new_slots)
        # the initial wave is part of burst 0: nothing to skip when its
        # results arrive
        sched.clear_last_admitted()
        lengths_dev = torch.zeros(B, dtype=torch.int32, device=self.device)
        last_dev = torch.zeros(B, dtype=torch.int32, device=self.device)

        counter.start_record()
        pending = None
        prev_total = sched.total_generated()
        while True:
            dispatched = sched.processing_count() > 0
            if dispatched:
                lengths_dev, last_dev, ticket = self._dispatch(lengths_dev,
                                                               last_dev)
            if pending is not None:
                with phase("process_results"):
                    results = self._finish_pull(pending)  # the one sync
                    finished = sched.process_results(
                        results, self.lengths, self.last_tokens)
                    total = sched.total_generated()
                    counter.add_record_if_recording(total - prev_total)
                    prev_total = total
                with phase("schedule"):
                    preempted = sched.alloc_or_free(finished, self.table,
                                                    self.lengths)
                    self.stats.preemptions += len(preempted)
                    new_slots = sched.insert_new(
                        self.prompts, self.lengths, self.last_tokens,
                        self.table)
                    self._pack(new_slots, preempted)
                if new_slots:
                    with phase("prefill"):
                        self._run_prefill(new_slots)
            if not dispatched:
                if sched.is_done():
                    break
                pending = None
                continue
            pending = ticket
        counter.stop_record()
        # surface finished requests back into the item storage
        for rid, tokens, prompt_len in sched.finished_requests():
            counter.note_first_token(rid)
            item_storage.add_finished(Request(rid, tokens,
                                              prompt_len=prompt_len))
