// Native host-side continuous-batching scheduler.
//
// The port's copy of the JAX package's csrc/scheduler.cpp, unchanged below
// this comment: the C++ twin of the port's Python scheduler modules
// (min_llm_inference_tpu_torch/runtime/item_storage.py,
// paged_scheduler.py), built at first use by the host C++ compiler into
// min_llm_inference_tpu_torch/_build/ (ops/_build.py) and bound with ctypes
// (runtime/native.py). Semantics are identical by construction and
// differential-tested from Python (tests/test_torch_native.py):
//   * FIFO new-items queue, preempted requests re-queued at the HEAD with
//     generated tokens kept (recompute-on-preempt);
//   * process_results walks per-round result columns, appends tokens,
//     finishes on EOF / n_seq cap, and maintains the host mirror of the
//     device's lengths/last_tokens arrays;
//   * paged admission (free >= min(init_pages, W) and >= head need),
//     one-page growth, tail-preemption when the pool runs dry, per-slot
//     page grants capped at the table row width.
//
// Exposed as a C ABI for ctypes. All staging buffers
// (prompts/lengths/last/table) are caller-owned int32 arrays that this
// library writes in place -- the same arrays the engine ships to the
// device.

#include <cassert>
#include <cstdint>
#include <cstring>
#include <deque>
#include <list>
#include <unordered_map>
#include <unordered_set>
#include <utility>
#include <vector>

namespace {

constexpr int32_t kEmptyRowTokenId = -1;

struct Request {
  int64_t id;
  std::vector<int32_t> tokens;
  int32_t prompt_len;
  bool first_token_emitted = false;
};

struct SlotPages {
  int32_t slot;
  std::vector<int32_t> pages;
};

struct Scheduler {
  // config
  int32_t n_slots, n_seq, n_pages, pages_per_slot, page_size, init_pages,
      n_rounds, eof_id;
  // page-growth/admission horizon in tokens (pipelined engines use
  // 2*n_rounds; sequential uses n_rounds)
  int32_t lookahead;
  // slots admitted by the previous insert call: their EMPTY rows in the
  // next processed burst are expected (the burst was dispatched before
  // they were admitted)
  std::unordered_set<int32_t> last_admitted;

  // request state
  std::deque<Request> new_items;
  std::unordered_map<int32_t, Request> processing;  // slot -> request
  std::vector<Request> finished;

  // page state
  std::vector<int32_t> free_pages;            // LIFO-ish free list
  std::list<SlotPages> used;                  // insertion-ordered
  std::vector<int32_t> table;                 // [n_slots * pages_per_slot]
  bool table_dirty = true;

  int64_t total_generated = 0;

  int free_count() const { return static_cast<int>(free_pages.size()); }

  std::vector<int32_t> pop_pages(int n) {
    assert(free_count() >= n);
    std::vector<int32_t> out(free_pages.begin(), free_pages.begin() + n);
    free_pages.erase(free_pages.begin(), free_pages.begin() + n);
    return out;
  }

  void return_pages(std::vector<int32_t>&& pages) {
    free_pages.insert(free_pages.end(), pages.begin(), pages.end());
  }
};

int32_t ceil_div(int32_t a, int32_t b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

void* mls_create(int32_t n_slots, int32_t n_seq, int32_t n_pages,
                 int32_t pages_per_slot, int32_t page_size,
                 int32_t init_pages, int32_t n_rounds, int32_t eof_id) {
  auto* s = new Scheduler();
  s->n_slots = n_slots;
  s->n_seq = n_seq;
  s->n_pages = n_pages;
  s->pages_per_slot = pages_per_slot;
  s->page_size = page_size;
  s->init_pages = init_pages;
  s->n_rounds = n_rounds;
  s->eof_id = eof_id;
  s->lookahead = 2 * n_rounds;  // pipelined default; see mls_set_lookahead
  s->free_pages.resize(n_pages);
  for (int32_t i = 0; i < n_pages; ++i) s->free_pages[i] = i;
  s->table.assign(static_cast<size_t>(n_slots) * pages_per_slot, 0);
  return s;
}

void mls_destroy(void* h) { delete static_cast<Scheduler*>(h); }

void mls_set_lookahead(void* h, int32_t lookahead) {
  static_cast<Scheduler*>(h)->lookahead = lookahead;
}

// The initial admission wave IS included in the first dispatched burst
// (prefill + packed updates precede dispatch 0), so it must not be
// skipped when that burst's results are processed.
void mls_clear_last_admitted(void* h) {
  static_cast<Scheduler*>(h)->last_admitted.clear();
}

void mls_add_request(void* h, int64_t id, const int32_t* tokens, int32_t n) {
  auto* s = static_cast<Scheduler*>(h);
  Request r;
  r.id = id;
  r.tokens.assign(tokens, tokens + n);
  r.prompt_len = n;
  s->new_items.push_back(std::move(r));
}

int32_t mls_new_count(void* h) {
  return static_cast<int32_t>(static_cast<Scheduler*>(h)->new_items.size());
}

int32_t mls_processing_count(void* h) {
  return static_cast<int32_t>(static_cast<Scheduler*>(h)->processing.size());
}

int32_t mls_is_done(void* h) {
  auto* s = static_cast<Scheduler*>(h);
  return (s->new_items.empty() && s->processing.empty()) ? 1 : 0;
}

// Walk one host step's decode results [n_slots * n_rounds]; append tokens,
// finish on EOF / cap; update the lengths/last mirrors in place.
// Returns n_finished; finished slot ids in finished_out (cap n_slots);
// number of generated tokens accumulated into total_generated.
int32_t mls_process_results(void* h, const int32_t* results, int32_t n_rounds,
                            int32_t* lengths, int32_t* last_tokens,
                            int32_t* finished_out) {
  auto* s = static_cast<Scheduler*>(h);
  int32_t n_finished = 0;
  for (int32_t slot = 0; slot < s->n_slots; ++slot) {
    // pipelined semantics: skip slots admitted after the burst was
    // dispatched, and slots preempted while it was in flight (their tokens
    // are dropped; greedy determinism regenerates them on re-admission)
    if (s->last_admitted.count(slot)) continue;
    auto pit = s->processing.find(slot);
    if (pit == s->processing.end()) continue;
    bool empty = false, fin = false;
    for (int32_t j = 0; j < n_rounds; ++j) {
      int32_t tok = results[slot * n_rounds + j];
      if (tok == kEmptyRowTokenId) {
        empty = true;
      } else {
        Request& req = pit->second;
        req.tokens.push_back(tok);
        s->total_generated += 1;
        if (static_cast<int32_t>(req.tokens.size()) >= s->n_seq ||
            tok == s->eof_id) {
          fin = true;
        }
      }
      if (fin || empty) break;
    }
    if (fin || empty) finished_out[n_finished++] = slot;
    if (fin) {
      auto it = s->processing.find(slot);
      s->finished.push_back(std::move(it->second));
      s->processing.erase(it);
      lengths[slot] = 0;
    }
  }
  // host mirror of device state: live slots hold their full token count
  for (auto& [slot, req] : s->processing) {
    lengths[slot] = static_cast<int32_t>(req.tokens.size());
    last_tokens[slot] = req.tokens.back();
  }
  s->last_admitted.clear();
  return n_finished;
}

// Free finished slots' pages; grow live slots by one page when needed;
// preempt the used-list tail when the pool is dry. Writes the page table
// into `table` ([n_slots * pages_per_slot], caller-owned).
// Returns n_preempted (slot ids in preempted_out).
int32_t mls_alloc_or_free(void* h, const int32_t* finished,
                          int32_t n_finished, int32_t* table,
                          int32_t* lengths, int32_t* preempted_out) {
  auto* s = static_cast<Scheduler*>(h);
  std::unordered_set<int32_t> fin(finished, finished + n_finished);
  int32_t n_preempted = 0;

  for (auto it = s->used.begin(); it != s->used.end();) {
    if (fin.count(it->slot)) {
      s->return_pages(std::move(it->pages));
      it = s->used.erase(it);
    } else {
      ++it;
    }
  }

  for (auto it = s->used.begin(); it != s->used.end();) {
    int32_t slot = it->slot;
    auto pit = s->processing.find(slot);
    assert(pit != s->processing.end());
    int32_t n_tokens = static_cast<int32_t>(pit->second.tokens.size());
    int32_t n_owned = static_cast<int32_t>(it->pages.size());
    if (n_owned >= s->pages_per_slot) {
      ++it;  // capped at table row width (slot terminates at the cap)
    } else if (n_tokens + s->lookahead > n_owned * s->page_size) {
      if (s->free_count() > 0) {
        int32_t page = s->pop_pages(1)[0];
        it->pages.push_back(page);
        table[slot * s->pages_per_slot + n_owned] = page;
        s->table_dirty = true;
        // re-check the same slot: a multi-burst horizon may need more
      } else if (std::next(it) == s->used.end()) {
        // pool dry; this slot IS the tail: preempt itself
        s->new_items.push_front(std::move(pit->second));
        s->processing.erase(pit);
        s->return_pages(std::move(it->pages));
        it = s->used.erase(it);
        preempted_out[n_preempted++] = slot;
        lengths[slot] = 0;
      } else {
        // pool dry: preempt the tail to fund this slot, retry
        SlotPages victim = std::move(s->used.back());
        s->used.pop_back();
        auto vit = s->processing.find(victim.slot);
        s->new_items.push_front(std::move(vit->second));
        s->processing.erase(vit);
        s->return_pages(std::move(victim.pages));
        preempted_out[n_preempted++] = victim.slot;
        lengths[victim.slot] = 0;
      }
    } else {
      ++it;
    }
  }
  return n_preempted;
}

// Paged admission over unoccupied slots. Writes prompts/lengths/last/table
// staging in place. Returns number of admitted slots (ids in new_slots_out).
int32_t mls_insert_new(void* h, int32_t* prompts, int32_t* lengths,
                       int32_t* last_tokens, int32_t* table,
                       int32_t* new_slots_out) {
  auto* s = static_cast<Scheduler*>(h);
  std::unordered_set<int32_t> occupied;
  for (const auto& sp : s->used) occupied.insert(sp.slot);
  int32_t n_new = 0;
  for (int32_t slot = 0; slot < s->n_slots; ++slot) {
    if (occupied.count(slot)) continue;
    bool admit = false;
    if (!s->new_items.empty() &&
        s->free_count() >= std::min(s->init_pages, s->pages_per_slot)) {
      int32_t head_len =
          static_cast<int32_t>(s->new_items.front().tokens.size());
      int32_t need = std::min(ceil_div(head_len + s->lookahead, s->page_size),
                              s->pages_per_slot);
      admit = s->free_count() >= need;
    }
    if (admit) {
      Request req = std::move(s->new_items.front());
      s->new_items.pop_front();
      int32_t len = static_cast<int32_t>(req.tokens.size());
      assert(len + 1 <= s->n_seq);
      lengths[slot] = len;
      std::memcpy(prompts + static_cast<size_t>(slot) * s->n_seq,
                  req.tokens.data(), sizeof(int32_t) * len);
      last_tokens[slot] = req.tokens.back();
      int32_t n_pages = std::min(
          std::max(ceil_div(len + s->lookahead, s->page_size), s->init_pages),
          s->pages_per_slot);
      std::vector<int32_t> pages = s->pop_pages(n_pages);
      for (int32_t j = 0; j < n_pages; ++j)
        table[slot * s->pages_per_slot + j] = pages[j];
      s->used.push_back(SlotPages{slot, std::move(pages)});
      s->processing.emplace(slot, std::move(req));
      s->table_dirty = true;
      s->last_admitted.insert(slot);
      new_slots_out[n_new++] = slot;
    } else {
      lengths[slot] = 0;
    }
  }
  return n_new;
}

int32_t mls_table_dirty_clear(void* h) {
  auto* s = static_cast<Scheduler*>(h);
  int32_t d = s->table_dirty ? 1 : 0;
  s->table_dirty = false;
  return d;
}

int32_t mls_free_page_count(void* h) {
  return static_cast<Scheduler*>(h)->free_count();
}

int64_t mls_total_generated(void* h) {
  return static_cast<Scheduler*>(h)->total_generated;
}

int32_t mls_finished_count(void* h) {
  return static_cast<int32_t>(static_cast<Scheduler*>(h)->finished.size());
}

// Fetch finished request idx: writes id and up to `cap` tokens; returns
// the token count (call with cap=0 to query the length).
int32_t mls_get_finished(void* h, int32_t idx, int64_t* id_out,
                         int32_t* tokens_out, int32_t cap) {
  auto* s = static_cast<Scheduler*>(h);
  const Request& r = s->finished.at(idx);
  *id_out = r.id;
  int32_t n = static_cast<int32_t>(r.tokens.size());
  if (tokens_out && cap >= n)
    std::memcpy(tokens_out, r.tokens.data(), sizeof(int32_t) * n);
  return n;
}

int32_t mls_get_finished_prompt_len(void* h, int32_t idx) {
  auto* s = static_cast<Scheduler*>(h);
  return s->finished.at(idx).prompt_len;
}

}  // extern "C"
