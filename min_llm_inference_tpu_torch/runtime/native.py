"""ctypes bindings for the native C++ scheduler (csrc/scheduler.cpp).

The port's copy of min_llm_inference_tpu/runtime/native.py. The native
scheduler owns the complete host-side scheduling state machine -- request
queues, processing map, page pool, page table, preemption -- and writes the
int32 staging buffers (prompts/lengths/last/table) in place; Python keeps
only the numpy views it ships to the device.

The library is built from the port's own copy of the source, at first use,
by the host C++ compiler into the package's ``_build/`` (ops/_build.py).
Without a compiler ``NativeScheduler`` raises; nothing falls back to the
Python scheduler.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional

import numpy as np

from ..ops import _build

_SOURCE = "scheduler.cpp"
_i32p = ctypes.POINTER(ctypes.c_int32)


@functools.cache
def _load_lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    lib.mls_create.restype = ctypes.c_void_p
    lib.mls_create.argtypes = [ctypes.c_int32] * 8
    lib.mls_destroy.argtypes = [ctypes.c_void_p]
    lib.mls_set_lookahead.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.mls_clear_last_admitted.argtypes = [ctypes.c_void_p]
    lib.mls_add_request.argtypes = [ctypes.c_void_p, ctypes.c_int64, _i32p,
                                    ctypes.c_int32]
    for name in ("mls_new_count", "mls_processing_count", "mls_is_done",
                 "mls_table_dirty_clear", "mls_free_page_count",
                 "mls_finished_count"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int32
        fn.argtypes = [ctypes.c_void_p]
    lib.mls_total_generated.restype = ctypes.c_int64
    lib.mls_total_generated.argtypes = [ctypes.c_void_p]
    lib.mls_process_results.restype = ctypes.c_int32
    lib.mls_process_results.argtypes = [ctypes.c_void_p, _i32p, ctypes.c_int32,
                                        _i32p, _i32p, _i32p]
    lib.mls_alloc_or_free.restype = ctypes.c_int32
    lib.mls_alloc_or_free.argtypes = [ctypes.c_void_p, _i32p, ctypes.c_int32,
                                      _i32p, _i32p, _i32p]
    lib.mls_insert_new.restype = ctypes.c_int32
    lib.mls_insert_new.argtypes = [ctypes.c_void_p] + [_i32p] * 5
    lib.mls_get_finished.restype = ctypes.c_int32
    lib.mls_get_finished.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                     ctypes.POINTER(ctypes.c_int64), _i32p,
                                     ctypes.c_int32]
    lib.mls_get_finished_prompt_len.restype = ctypes.c_int32
    lib.mls_get_finished_prompt_len.argtypes = [ctypes.c_void_p,
                                                ctypes.c_int32]
    return lib


def native_available() -> bool:
    """Whether the native scheduler builds and loads here."""
    try:
        _load_lib()
        return True
    except (OSError, RuntimeError):
        return False


def _ptr(a: np.ndarray) -> _i32p:
    if a.dtype != np.int32 or not a.flags["C_CONTIGUOUS"]:
        raise ValueError("native scheduler buffers are C-contiguous int32")
    return a.ctypes.data_as(_i32p)


class NativeScheduler:
    """Owns ALL host scheduling state natively; Python passes staging
    arrays + decode results and gets back slot lists."""

    def __init__(self, n_slots: int, n_seq: int, n_pages: int,
                 pages_per_slot: int, page_size: int, init_pages: int,
                 n_rounds: int, eof_id: int, lookahead: Optional[int] = None):
        self._lib = _load_lib()
        self._h = ctypes.c_void_p(
            self._lib.mls_create(n_slots, n_seq, n_pages, pages_per_slot,
                                 page_size, init_pages, n_rounds, eof_id)
        )
        if lookahead is not None:
            self._lib.mls_set_lookahead(self._h, lookahead)
        self.n_slots = n_slots
        self._scratch_slots = np.zeros(n_slots, dtype=np.int32)
        self._scratch_preempt = np.zeros(n_slots, dtype=np.int32)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mls_destroy(self._h)
            self._h = None

    def add_request(self, req_id: int, tokens) -> None:
        arr = np.asarray(tokens, dtype=np.int32)
        self._lib.mls_add_request(self._h, req_id, _ptr(arr), len(arr))

    def insert_new(self, prompts, lengths, last_tokens, table) -> List[int]:
        n = self._lib.mls_insert_new(
            self._h, _ptr(prompts), _ptr(lengths), _ptr(last_tokens),
            _ptr(table), _ptr(self._scratch_slots),
        )
        return self._scratch_slots[:n].tolist()

    def process_results(self, results: np.ndarray, lengths,
                        last_tokens) -> np.ndarray:
        results = np.ascontiguousarray(results, dtype=np.int32)
        n_rounds = results.shape[1] if results.ndim == 2 else 1
        n = self._lib.mls_process_results(
            self._h, _ptr(results), n_rounds, _ptr(lengths),
            _ptr(last_tokens), _ptr(self._scratch_slots),
        )
        return self._scratch_slots[:n]

    def alloc_or_free(self, finished: np.ndarray, table, lengths) -> List[int]:
        finished = np.ascontiguousarray(finished, dtype=np.int32)
        n = self._lib.mls_alloc_or_free(
            self._h, _ptr(finished), len(finished), _ptr(table),
            _ptr(lengths), _ptr(self._scratch_preempt),
        )
        return self._scratch_preempt[:n].tolist()

    def is_done(self) -> bool:
        return bool(self._lib.mls_is_done(self._h))

    def new_count(self) -> int:
        return self._lib.mls_new_count(self._h)

    def processing_count(self) -> int:
        return self._lib.mls_processing_count(self._h)

    def free_page_count(self) -> int:
        return self._lib.mls_free_page_count(self._h)

    def finished_count(self) -> int:
        return self._lib.mls_finished_count(self._h)

    def clear_last_admitted(self) -> None:
        self._lib.mls_clear_last_admitted(self._h)

    def table_dirty_clear(self) -> bool:
        return bool(self._lib.mls_table_dirty_clear(self._h))

    def total_generated(self) -> int:
        return self._lib.mls_total_generated(self._h)

    def finished_requests(self):
        """[(id, tokens, prompt_len)] of all finished requests."""
        out = []
        rid = ctypes.c_int64()
        for i in range(self.finished_count()):
            ln = self._lib.mls_get_finished(self._h, i, ctypes.byref(rid),
                                            None, 0)
            buf = np.zeros(ln, dtype=np.int32)
            self._lib.mls_get_finished(self._h, i, ctypes.byref(rid),
                                       _ptr(buf), ln)
            out.append((rid.value, buf.tolist(),
                        self._lib.mls_get_finished_prompt_len(self._h, i)))
        return out
