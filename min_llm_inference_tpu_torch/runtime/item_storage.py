"""Request storage + decode-result processing (host side).

The port's copy of min_llm_inference_tpu/runtime/item_storage.py: the
reference's L4 request layer
(include/item_storage.h, src/item_storage.cpp). Semantics preserved:

  * FIFO new-items queue; preempted requests are re-queued at the HEAD with
    all tokens generated so far — recompute-on-preempt
    (item_storage.cpp:75-79,190-196).
  * ``process_decoder_result`` (item_storage.cpp:97-139): walk each slot's
    per-round result columns; EMPTY_ROW_TOKEN_ID stops the row; otherwise
    append the token (EOF included), count it, and finish the request when
    it hits EOF or the n_seq cap.
  * ``is_done``: nothing in flight and nothing queued (item_storage.cpp:186).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np

from ..constants import EMPTY_ROW_TOKEN_ID, EOF_TOKEN_ID
from ..metrics import get_global_throughput_counter


@dataclass
class Request:
    """One sequence: id + token list (prompt, then generated tokens).

    The reference's IdTokensPair (item_storage.h:9); ``prompt_len`` is
    retained for TTFT accounting (not in the reference).
    """

    id: int
    tokens: List[int]
    prompt_len: int = -1

    def __post_init__(self):
        if self.prompt_len < 0:
            self.prompt_len = len(self.tokens)


class ItemStorage:
    """New-items queue + finished store (reference ItemStorage,
    item_storage.h:27-47)."""

    def __init__(self) -> None:
        self._new: Deque[Request] = deque()
        self.finished: Dict[int, Request] = {}

    def add_new_item(self, req: Request) -> None:
        self._new.append(req)
        get_global_throughput_counter().note_submit(req.id)

    def add_new_item_to_head(self, req: Request) -> None:
        self._new.appendleft(req)

    def pop_new_items(self, n: int) -> List[Request]:
        out = []
        while self._new and len(out) < n:
            out.append(self._new.popleft())
        return out

    def add_finished(self, req: Request) -> None:
        self.finished[req.id] = req

    def new_count(self) -> int:
        return len(self._new)

    def head_length(self) -> int:
        """Prompt+generated token count of the queue head
        (item_storage.cpp head_length — used for paged admission)."""
        return len(self._new[0].tokens)


class ProcessingStorage:
    """batch-slot -> in-flight request map (reference ProcessingStorage,
    item_storage.h:49-62)."""

    def __init__(self) -> None:
        self._by_slot: Dict[int, Request] = {}

    def put(self, slot: int, req: Request) -> None:
        self._by_slot[slot] = req

    def get(self, slot: int) -> Request:
        return self._by_slot[slot]

    def contains(self, slot: int) -> bool:
        return slot in self._by_slot

    def move_to_finished(self, slot: int, item_storage: ItemStorage) -> None:
        item_storage.add_finished(self._by_slot.pop(slot))

    def move_to_new(self, slot: int, item_storage: ItemStorage) -> None:
        """Preemption path: back to the head of the new queue, tokens kept
        (item_storage.cpp:75-79)."""
        item_storage.add_new_item_to_head(self._by_slot.pop(slot))

    def size(self) -> int:
        return len(self._by_slot)

    def slots(self):
        return self._by_slot.keys()


def process_decoder_result(
    results: np.ndarray,
    item_storage: ItemStorage,
    processing: ProcessingStorage,
    n_seq: int,
    eof_token_id: int = EOF_TOKEN_ID,
    skip_slots=frozenset(),
    pipelined: bool = False,
) -> List[int]:
    """Apply one host step's decode results (reference
    item_storage.cpp:97-139). results: [n_slots] or [n_slots, n_rounds].
    Returns finished slot indices (freed slots for re-insertion).

    The one result walk of the host engines (the JAX package keeps a
    native twin in csrc/scheduler.cpp). Callers select the loop contract:

      * pipelined=False (synchronous engines): an EMPTY row marks a free
        slot and is reported finished without touching ``processing``.
      * pipelined=True (two-deep pipelined engines): slots in
        ``skip_slots`` (admitted after the burst was dispatched — their
        EMPTY rows are expected) and slots no longer in ``processing``
        (preempted in flight; their tokens are dropped and regenerated
        identically after re-admission — greedy determinism) are skipped.
    """
    if results.ndim == 1:
        results = results[:, None]
    n_slots, n_rounds = results.shape
    counter = get_global_throughput_counter()
    finished_indices: List[int] = []
    total_tokens = 0
    for slot in range(n_slots):
        if pipelined and (slot in skip_slots or not processing.contains(slot)):
            continue
        empty = False
        finished = False
        for j in range(n_rounds):
            tok = int(results[slot, j])
            if tok == EMPTY_ROW_TOKEN_ID:
                empty = True
            else:
                req = processing.get(slot)
                if len(req.tokens) == req.prompt_len:
                    counter.note_first_token(req.id)
                req.tokens.append(tok)
                total_tokens += 1
                if len(req.tokens) >= n_seq or tok == eof_token_id:
                    finished = True
            if finished or empty:
                break
        if finished or empty:
            finished_indices.append(slot)
        if finished:
            processing.move_to_finished(slot, item_storage)
    counter.add_record_if_recording(total_tokens)
    return finished_indices


def insert_new_items_dense(
    finished_indices: List[int],
    prompts: np.ndarray,     # [n_slots, n_seq] staging (mutated)
    lengths: np.ndarray,     # [n_slots] staging (mutated)
    last_tokens: np.ndarray,  # [n_slots] staging (mutated)
    item_storage: ItemStorage,
    processing: ProcessingStorage,
) -> List[int]:
    """Contiguous-backend insertion (reference item_storage.cpp:141-180):
    pop at most len(finished_indices) new requests into exactly those slots;
    slots without a request get length 0. Returns newly filled slot ids."""
    if not finished_indices:
        return []
    n_seq = prompts.shape[1]
    new_items = item_storage.pop_new_items(len(finished_indices))
    new_slots: List[int] = []
    for i, slot in enumerate(finished_indices):
        if i >= len(new_items):
            lengths[slot] = 0
        else:
            req = new_items[i]
            assert len(req.tokens) + 1 <= n_seq
            lengths[slot] = len(req.tokens)
            prompts[slot, : len(req.tokens)] = req.tokens
            last_tokens[slot] = req.tokens[-1]
            processing.put(slot, req)
            new_slots.append(slot)
    return new_slots


def is_done(item_storage: ItemStorage, processing: ProcessingStorage) -> bool:
    return processing.size() + item_storage.new_count() == 0
