"""The port's paged scheduler (runtime/paged_scheduler.py): the paged cases
of tests/test_scheduler.py, line for line on the port's modules, and the
port held against the JAX package's scheduler: identical PagePool,
PageTable and processing states after the same operation sequence on
identical seeded inputs."""

import numpy as np
import pytest

from min_llm_inference_tpu.runtime import item_storage as jis
from min_llm_inference_tpu.runtime import paged_scheduler as jps
from min_llm_inference_tpu_torch.constants import (
    DEFAULT_INIT_NUM_BLOCKS,
    DEFAULT_PAGE_SIZE,
    EMPTY_ROW_TOKEN_ID,
    EOF_TOKEN_ID,
)
from min_llm_inference_tpu_torch.runtime import item_storage as tis
from min_llm_inference_tpu_torch.runtime import paged_scheduler as tps
from min_llm_inference_tpu_torch.runtime.item_storage import (
    ItemStorage,
    ProcessingStorage,
    Request,
    process_decoder_result,
)
from min_llm_inference_tpu_torch.runtime.paged_scheduler import (
    PagePool,
    PageTable,
    allocate_or_free_pages,
    ceil_div,
    insert_new_items_paged,
)

P = DEFAULT_PAGE_SIZE          # 16
INIT = DEFAULT_INIT_NUM_BLOCKS  # 4


def make_items(lengths, rng, start_id=0, mod=None):
    mod = mod or tis
    store = mod.ItemStorage()
    for i, ln in enumerate(lengths):
        store.add_new_item(mod.Request(
            start_id + i, [int(t) for t in rng.integers(0, EOF_TOKEN_ID, ln)]))
    return store


class PagedFixture:
    """Scheduler state over the port's modules (or the JAX package's,
    ``sched``/``storage`` given)."""

    def __init__(self, n_slots, n_pages, n_seq, item_lengths, rng,
                 sched=tps, storage=tis, init=INIT):
        self.sched, self.storage, self.init = sched, storage, init
        self.n_slots, self.n_seq = n_slots, n_seq
        self.item_storage = make_items(item_lengths, rng, mod=storage)
        self.processing = storage.ProcessingStorage()
        self.pool = sched.PagePool(n_pages)
        self.table = sched.PageTable(n_slots, ceil_div(n_seq, P))
        self.prompts = np.zeros((n_slots, n_seq), dtype=np.int32)
        self.lengths = np.zeros(n_slots, dtype=np.int32)
        self.last = np.zeros(n_slots, dtype=np.int32)

    def insert(self, rounds=1, lookahead=None):
        return self.sched.insert_new_items_paged(
            self.prompts, self.lengths, self.last,
            self.item_storage, self.processing, self.pool, self.table,
            rounds, P, self.init, lookahead,
        )

    def realloc(self, finished, rounds=1, lookahead=None):
        return self.sched.allocate_or_free_pages(
            self.table, self.pool, self.processing, self.item_storage,
            finished, rounds, P, lookahead,
        )

    def process(self, results):
        return self.storage.process_decoder_result(
            results, self.item_storage, self.processing, self.n_seq)

    def snapshot(self):
        """Everything the scheduler owns, as plain Python values."""
        return {
            "free": list(self.pool._free),
            "table": self.table.table.tolist(),
            "used": [(s, list(p)) for s, p in self.table.used],
            "processing": sorted(
                (s, r.id, list(r.tokens))
                for s, r in self.processing._by_slot.items()),
            "queue": [(r.id, list(r.tokens)) for r in self.item_storage._new],
            "finished": sorted(
                (i, list(r.tokens))
                for i, r in self.item_storage.finished.items()),
            "staging": (self.prompts.tolist(), self.lengths.tolist(),
                        self.last.tolist()),
        }


def test_insert_all_items(rng):
    # InsertAllItemsTest: pool exactly fits n_slots * INIT; 2x items queued
    n_slots = 24
    fix = PagedFixture(n_slots, n_slots * INIT, P * INIT * 2,
                       rng.integers(1, P * INIT - 1, n_slots * 2).tolist(), rng)
    item_lens = [len(fix.item_storage._new[i].tokens) for i in range(n_slots)]
    new_slots = fix.insert()
    assert new_slots == list(range(n_slots))
    assert fix.item_storage.new_count() == n_slots
    assert fix.pool.free_count() == 0
    for i in range(n_slots):
        assert fix.lengths[i] == item_lens[i]
        req = fix.processing.get(i)
        assert fix.prompts[i, : len(req.tokens)].tolist() == req.tokens


def test_insert_new_items_partial(rng):
    # InsertNewItemsTest: n_slots-1 items, then add 2 more; only 1 fits
    n_slots = 24
    fix = PagedFixture(n_slots, n_slots * INIT, P * INIT * 2,
                       rng.integers(1, P * INIT - 1, n_slots - 1).tolist(), rng)
    assert fix.insert() == list(range(n_slots - 1))
    ln = int(rng.integers(1, P * INIT - 1))
    fix.item_storage.add_new_item(Request(100, [1] * ln))
    fix.item_storage.add_new_item(Request(101, [2] * ln))
    new_slots = fix.insert()
    assert new_slots == [n_slots - 1]
    assert fix.item_storage.new_count() == 1
    assert fix.pool.free_count() == 0
    assert fix.lengths[n_slots - 1] == ln


def test_return_free_blocks_on_finish(rng):
    # ReturnFreeBlocksTest: finish some slots -> their pages return, then
    # exactly that many new items are admitted.
    n_slots = 24
    fix = PagedFixture(n_slots, n_slots * INIT, P * INIT * 2,
                       rng.integers(1, P * INIT - 2, n_slots * 2).tolist(), rng)
    fix.insert()
    assert fix.pool.free_count() == 0
    n_fin = 7
    fin_slots = sorted(rng.choice(n_slots, n_fin, replace=False).tolist())
    results = rng.integers(0, EOF_TOKEN_ID - 1, n_slots).astype(np.int32)
    results[fin_slots] = EOF_TOKEN_ID
    finished = process_decoder_result(results, fix.item_storage,
                                      fix.processing, fix.n_seq)
    assert finished == fin_slots
    fix.realloc(finished)
    assert fix.pool.free_count() == n_fin * INIT
    assert len(fix.item_storage.finished) == n_fin
    assert fix.insert() == fin_slots


def test_allocate_more_blocks(rng):
    # AllocateMoreBlocksTest: slots at len P*INIT-1 cross a page boundary
    # after one token and get exactly one extra page each.
    n_slots = 24
    n_grow = 5
    lens = rng.integers(1, P * INIT - 2, n_slots // 2).tolist()
    grow_idx = sorted(rng.choice(n_slots // 2, n_grow, replace=False).tolist())
    for i in grow_idx:
        lens[i] = P * INIT - 1
    fix = PagedFixture(n_slots, n_slots * INIT, P * INIT * 2, lens, rng)
    fix.insert()
    free0 = fix.pool.free_count()
    assert free0 == n_slots * INIT - (n_slots // 2) * INIT
    results = rng.integers(0, EOF_TOKEN_ID - 1, n_slots).astype(np.int32)
    results[n_slots // 2:] = EMPTY_ROW_TOKEN_ID  # never-admitted slots
    finished = process_decoder_result(results, fix.item_storage,
                                      fix.processing, fix.n_seq)
    assert finished == list(range(n_slots // 2, n_slots))
    fix.realloc(finished)
    assert fix.pool.free_count() == free0 - n_grow


def test_free_the_last_blocks_self_preempt(rng):
    # FreeTheLastBlocksTest: pool exhausted, only the used-list tail needs a
    # page -> it preempts ITSELF; its tokens (incl. the one just decoded)
    # land at the head of the new queue.
    n_slots = 24
    lens = rng.integers(1, P * INIT - 2, n_slots * 2).tolist()
    lens[n_slots - 1] = P * INIT - 1
    fix = PagedFixture(n_slots, n_slots * INIT, P * INIT * 2, lens, rng)
    fix.insert()
    assert fix.pool.free_count() == 0
    results = rng.integers(0, EOF_TOKEN_ID - 1, n_slots).astype(np.int32)
    finished = process_decoder_result(results, fix.item_storage,
                                      fix.processing, fix.n_seq)
    preempted = fix.realloc(finished)
    assert preempted == [n_slots - 1]
    assert fix.pool.free_count() == INIT
    assert fix.item_storage.new_count() == n_slots + 1
    assert fix.item_storage.head_length() == P * INIT
    head = fix.item_storage.pop_new_items(1)[0]
    assert head.tokens[-1] == int(results[n_slots - 1])


def test_free_blocks_tail_preemption(rng):
    # FreeBlocks: to_fill needy slots vs INIT free pages -> preempt
    # ceil(to_fill/INIT)-1 tail slots; exact page accounting.
    n_slots = 24
    to_fill = 9
    to_free = ceil_div(to_fill, INIT) - 1
    lens = rng.integers(1, P * INIT - 2, n_slots - 1).tolist()
    needy = sorted(rng.choice(n_slots - 1 - to_free, to_fill,
                              replace=False).tolist())
    for i in needy:
        lens[i] = P * INIT - 1
    fix = PagedFixture(n_slots, n_slots * INIT, P * INIT * 2, lens, rng)
    fix.insert()
    assert fix.pool.free_count() == INIT
    results = rng.integers(0, EOF_TOKEN_ID - 1, n_slots).astype(np.int32)
    # slot n_slots-1 was never admitted (only n_slots-1 items) -> EMPTY row
    results[n_slots - 1] = EMPTY_ROW_TOKEN_ID
    finished = process_decoder_result(results, fix.item_storage,
                                      fix.processing, fix.n_seq)
    assert finished == [n_slots - 1]
    preempted = fix.realloc(finished)
    assert len(preempted) == to_free
    assert fix.pool.free_count() == INIT * to_free + INIT - to_fill
    assert fix.item_storage.new_count() == to_free


def test_pool_raises_on_exhaustion():
    pool = PagePool(2)
    with pytest.raises(RuntimeError):
        pool.pop_pages(3)


def test_freed_pages_return_at_the_tail():
    """After the first wave the free list is no longer sorted: tables
    fragment, which the one-slot kernel must take as they come."""
    pool = PagePool(6)
    table = PageTable(2, 3)
    table.add_slot_pages(0, pool.pop_pages(3))
    table.add_slot_pages(1, pool.pop_pages(2))
    pool.return_pages(table.used.pop(0)[1])
    assert pool._free == [5, 0, 1, 2]
    assert pool.pop_pages(2) == [5, 0]


@pytest.mark.parametrize("seed,n_pages,rounds,lookahead,init", [
    (1, 40, 4, 8, 4), (2, 10, 4, 8, 1), (3, 9, 2, None, 2), (4, 24, 1, 2, 1),
])
def test_scheduler_state_matches_jax(seed, n_pages, rounds, lookahead, init):
    """Port and JAX scheduler driven through the same admit / decode /
    free-grow-preempt sequence on identical seeded inputs hold identical
    pool, table, used-list, processing, queue and staging states after
    every step (pressure configs preempt; the sequence drains)."""
    B, S = 6, 64
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 40, 24).tolist()
    fixes = [PagedFixture(B, n_pages, S, lens, np.random.default_rng(seed),
                          sched=sched, storage=storage, init=init)
             for sched, storage in ((tps, tis), (jps, jis))]
    for fix in fixes:
        fix.insert(rounds, lookahead)
    assert fixes[0].snapshot() == fixes[1].snapshot()
    n_preempted = 0
    for step in range(400):
        results = np.full((B, rounds), EMPTY_ROW_TOKEN_ID, np.int32)
        for slot in range(B):
            if fixes[0].processing.contains(slot):
                results[slot] = rng.integers(0, EOF_TOKEN_ID + 1, rounds)
                results[slot, rng.random(rounds) < 0.08] = EOF_TOKEN_ID
        for fix in fixes:
            finished = fix.process(results)
            for slot in fix.processing.slots():
                req = fix.processing.get(slot)
                fix.lengths[slot] = len(req.tokens)
                fix.last[slot] = req.tokens[-1]
            pre = fix.realloc(finished, rounds, lookahead)
            fix.insert(rounds, lookahead)
        n_preempted += len(pre)
        assert fixes[0].snapshot() == fixes[1].snapshot(), f"step {step}"
        if tis.is_done(fixes[0].item_storage, fixes[0].processing):
            break
    assert tis.is_done(fixes[0].item_storage, fixes[0].processing)
    assert len(fixes[0].item_storage.finished) == len(lens)
    if n_pages < 16:
        assert n_preempted > 0
