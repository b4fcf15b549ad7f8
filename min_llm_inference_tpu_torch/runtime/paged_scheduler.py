"""Paged-KV page pool + page-table scheduler (host side).

The port's copy of min_llm_inference_tpu/runtime/paged_scheduler.py, itself
the Python rebuild of the reference's paged scheduling layer
(include/paged_item_storage.h, src/paged_item_storage.cpp) over integer
page ids into a pooled device KV array instead of raw device pointers. Host
numpy code, unchanged in names and semantics so its tests mirror
tests/test_scheduler.py line for line:

  * ``PagePool``  <- MemoryBlockManager (free list of fixed-size pages;
    freed pages return at the TAIL, so tables fragment after the first
    wave).
  * ``PageTable`` <- PagedAttentionsManager (host int32 table
    [n_slots, pages_per_slot] + insertion-ordered used list, whose tail is
    the preemption victim).
  * ``allocate_or_free_pages`` <- allocate_or_free_memory_blocks_if_needed:
    free finished slots' pages; grow a live slot that cannot fit
    ``len + horizon`` tokens one page at a time; when the pool is dry,
    PREEMPT the used-list tail (or the slot itself if it is the tail) back
    to the head of the queue (recompute-on-preempt).
  * ``insert_new_items_paged`` <- the paged insert_new_items overload:
    admit the queue head into free slots in order while free pages >=
    min(init_num_pages, W) and >= its need; grant max(need, init) pages,
    capped at W.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .item_storage import ItemStorage, ProcessingStorage, Request


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class PagePool:
    """Free list over integer page ids [0, n_pages)."""

    def __init__(self, n_pages: int) -> None:
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages))

    def free_count(self) -> int:
        return len(self._free)

    def pop_pages(self, n: int) -> List[int]:
        if len(self._free) < n:
            raise RuntimeError("No enough free KV pages")
        out = self._free[:n]
        del self._free[:n]
        return out

    def return_pages(self, pages: List[int]) -> None:
        self._free.extend(pages)


class PageTable:
    """Host page table + per-slot page ownership.

    ``table`` is the int32 [n_slots, pages_per_slot] array shipped to the
    device (stale entries beyond a slot's page count are garbage — device
    reads are length-masked). ``used`` preserves *insertion order*, which
    defines the preemption victim (the tail), exactly like the reference's
    std::list used_blocks_.
    """

    def __init__(self, n_slots: int, pages_per_slot: int) -> None:
        self.table = np.zeros((n_slots, pages_per_slot), dtype=np.int32)
        self.used: List[Tuple[int, List[int]]] = []  # (slot, page ids)
        self.dirty = True

    def occupied_slots(self) -> set:
        return {slot for slot, _ in self.used}

    def add_slot_pages(self, slot: int, pages: List[int]) -> None:
        assert len(pages) <= self.table.shape[1]
        self.table[slot, : len(pages)] = pages
        self.used.append((slot, pages))
        self.dirty = True

    def grow_slot(self, entry: Tuple[int, List[int]], page: int) -> None:
        slot, pages = entry
        pages.append(page)
        self.table[slot, len(pages) - 1] = page
        self.dirty = True

    def flush(self):
        """Return the table if it changed since last flush, else None —
        the analogue of maybe_flush_changes' lazy H2D sync."""
        if self.dirty:
            self.dirty = False
            return self.table
        return None


def allocate_or_free_pages(
    page_table: PageTable,
    pool: PagePool,
    processing: ProcessingStorage,
    item_storage: ItemStorage,
    finished_indices: List[int],
    n_forward_rounds: int,
    page_size: int,
    lookahead_tokens: Optional[int] = None,
) -> List[int]:
    """Returns the slots preempted this call (their device lengths must be
    zeroed by the caller before the next decode).

    ``lookahead_tokens`` is the page-growth horizon: how many tokens beyond
    the known length a live slot must have page room for. The sequential
    engine uses n_forward_rounds (one burst); the pipelined engine uses
    2*n_forward_rounds because it dispatches a burst before processing the
    previous burst's results."""
    assert 0 < n_forward_rounds <= page_size
    horizon = n_forward_rounds if lookahead_tokens is None else lookahead_tokens
    finished = set(finished_indices)
    preempted: List[int] = []

    # Phase 1: free pages of finished/emptied slots.
    kept: List[Tuple[int, List[int]]] = []
    for slot, pages in page_table.used:
        if slot in finished:
            pool.return_pages(pages)
        else:
            kept.append((slot, pages))
    page_table.used = kept

    # Phase 2: grow (or preempt) live slots that cannot fit the next
    # n_forward_rounds tokens.
    # Cap every slot at the page-table row width: a slot holding
    # ceil(n_seq/page_size) pages can store all n_seq tokens it can ever
    # produce before the cap terminates it, so growing past the row is both
    # unnecessary and an overflow. (The reference would overflow its table
    # row here when lengths+n_forward_rounds overshoots n_sequence —
    # set_block_pos with i_block >= width, paged_item_storage.cpp:174-177;
    # not replicated.)
    max_pages = page_table.table.shape[1]
    i = 0
    while i < len(page_table.used):
        entry = page_table.used[i]
        slot, pages = entry
        assert processing.contains(slot)
        n_tokens = len(processing.get(slot).tokens)
        if len(pages) >= max_pages:
            i += 1
        elif n_tokens + horizon > len(pages) * page_size:
            if pool.free_count() > 0:
                page_table.grow_slot(entry, pool.pop_pages(1)[0])
                # re-check the same slot: a multi-burst horizon may need
                # more than one page
            elif i == len(page_table.used) - 1:
                # Pool dry and this slot is the tail: preempt itself.
                processing.move_to_new(slot, item_storage)
                pool.return_pages(pages)
                page_table.used.pop(i)
                preempted.append(slot)
                # loop ends naturally
            else:
                # Pool dry: preempt the used-list tail to fund this slot.
                victim_slot, victim_pages = page_table.used.pop()
                processing.move_to_new(victim_slot, item_storage)
                pool.return_pages(victim_pages)
                preempted.append(victim_slot)
                # retry the same slot with the freed pages
        else:
            i += 1
    return preempted


def insert_new_items_paged(
    prompts: np.ndarray,      # [n_slots, n_seq] staging (mutated)
    lengths: np.ndarray,      # [n_slots] staging (mutated)
    last_tokens: np.ndarray,  # [n_slots] staging (mutated)
    item_storage: ItemStorage,
    processing: ProcessingStorage,
    pool: PagePool,
    page_table: PageTable,
    n_forward_rounds: int,
    page_size: int,
    init_num_pages: int,
    lookahead_tokens: Optional[int] = None,
) -> List[int]:
    """Admission: fill unoccupied slots from the new-items queue while pages
    last. Returns newly inserted slot ids."""
    assert 0 < n_forward_rounds <= page_size
    horizon = n_forward_rounds if lookahead_tokens is None else lookahead_tokens
    n_slots, n_seq = prompts.shape
    # Per-slot page grants are capped at the table row width (see
    # allocate_or_free_pages).
    max_pages = page_table.table.shape[1]
    occupied = page_table.occupied_slots()
    new_slots: List[int] = []
    for slot in range(n_slots):
        if slot in occupied:
            continue
        if (
            pool.free_count() >= min(init_num_pages, max_pages)
            and item_storage.new_count() > 0
            and pool.free_count()
            >= min(
                ceil_div(item_storage.head_length() + horizon, page_size),
                max_pages,
            )
        ):
            req = item_storage.pop_new_items(1)[0]
            assert len(req.tokens) + 1 <= n_seq
            lengths[slot] = len(req.tokens)
            prompts[slot, : len(req.tokens)] = req.tokens
            last_tokens[slot] = req.tokens[-1]
            n_pages = min(
                max(
                    ceil_div(len(req.tokens) + horizon, page_size),
                    init_num_pages,
                ),
                max_pages,
            )
            processing.put(slot, req)
            page_table.add_slot_pages(slot, pool.pop_pages(n_pages))
            new_slots.append(slot)
        else:
            lengths[slot] = 0
    return new_slots
