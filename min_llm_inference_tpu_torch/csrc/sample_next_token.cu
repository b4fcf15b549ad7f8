// Sampled next token for Hopper (sm_90a): one decode round's draw, top-k
// threshold, Gumbel-max and length rules in one launch.
//
// No TPU kernel to replace: the JAX package samples with XLA
//   min_llm_inference_tpu/ops/reference.py :: sample_next_token
//   (jax.random.split + jax.random.categorical, inside the burst's scan,
//   min_llm_inference_tpu/runtime/autonomous.py :: round_fn)
// and the plain PyTorch version of this kernel is
//   min_llm_inference_tpu_torch/ops/sampling.py :: sample_next_token_plain.
//
// Contract. logits [B, V] float32 (row stride ld), lengths [B] int32
// (0 = dead slot), key int64 [2] holding JAX's uint32 threefry key. The
// round's keys are split(key): counter 0 is the key carried to the next
// round (written to key_out by thread 0 of block 0 alone), counter 1 the
// draw key `sub`. Row b:
//   scaled[v] = logits[b, v] / tdiv      (IEEE division, tdiv = max(T, 1e-6))
//   for 0 < top_k < V: kth = the top_k-th largest scaled value (counted with
//     multiplicity); values below kth are out (ties at kth stay in);
//   bits[v]   = x0 ^ x1 of threefry2x32(sub, (i >> 32, i & 0xFFFFFFFF)),
//               i = b * V + v (jax.random.bits of shape [B, V]);
//   f         = float with mantissa bits >> 9 in [1, 2), minus 1;
//   u         = max(tiny, fma(f, 1 - tiny, tiny))   (jax.random.uniform)
//   g         = -log(-log(u))                        (jax.random.gumbel)
//   token     = argmax over the kept v of g + scaled[v], the lowest v on
//               ties; a dead row gets EMPTY_ROW_TOKEN_ID (-1) and length 0;
//   a live row's length grows by one, or resets to 0 on EOF or when it
//   reaches n_seq.
// Dead rows draw nothing. With bits_out (a check path), every row also
// writes its raw bits [B, V]; with select_out (a check path), every row
// writes which select found its kth (Select below).
//
// Bound on this card: the integer arithmetic of threefry (~77 32-bit
// operations a draw) where every element is drawn (top_k off), else the
// float32 logits read once. Three kernels:
//   * top_k off: every column draws, one block of 1024 threads per row,
//     the 20 rounds in registers (rotations as funnel shifts);
//   * top-k on narrow rows (at most 32 * kNarrowMaxJ = 2048 columns):
//     one warp per row, four rows a block, the row in registers (J = 32 or
//     64 keys a lane, columns lane + 32 j, every load in flight before the
//     first division), so the reference width's 1024 rows run in one wave
//     with no block barrier;
//   * top-k on wide rows: one block of 512 threads per row, three blocks
//     an SM (40 registers), the row read once, 8 loads a thread in flight.
// Under top-k only the kept elements (~top_k a row) draw, so the select
// sets the time. What the design does about it:
//   * every comparison is on select keys of the scaled values (the float
//     bits mapped so that unsigned order is float order, -0 folded into
//     +0), so ties made by the division stay ties;
//   * a cheap threshold first: each part takes its maximum (a lane's
//     columns for narrow rows; for wide rows a thread's 16 columns spread
//     over the row, read before the pass) and tau is the top_k-th largest
//     of these maxima, searched to 12 bits. The top_k parts with the
//     largest maxima each hold an element >= tau, so kth >= tau and every
//     kept element is >= tau. The elements >= tau (~20 a narrow row at
//     top_k 16, ~100 a wide one) are appended to a list of (key, column)
//     (a lane's by a prefix sum of counts over shuffles; a warp's by one
//     atomicAdd per ballot with a hit) and the exact kth is found among
//     them by a bitwise search on the keys (one warp: per bit, a count of
//     keys >= the trial by __reduce_add_sync) between tau and the largest
//     key, from their highest differing bit down. The draws run over the
//     list, one entry a lane;
//   * the exact select over the whole row, in the same kernel, when the
//     candidates overflow their list (heavy ties, an all-equal row, a row
//     of -inf with few finite values) or top_k exceeds the parts (32 lanes
//     of a narrow row, 512 threads of a wide one): for narrow rows the same
//     bitwise search over all of the lane's keys; for wide rows a radix
//     select (four 8-bit passes over the row, which stays in L2) whose
//     256-bin histogram takes one atomicAdd per distinct bin of a warp
//     (__match_any_sync) and whose bin scan is one warp (8 bins a lane,
//     prefix sums by shuffles); then every kept column draws.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kAllThreads = 1024;      // top_k off: threads of a row
constexpr int kAllWarps = kAllThreads / 32;
constexpr int kNarrowWarps = 4;        // rows of a narrow block
constexpr int kNarrowCap = 128;        // candidates a narrow row keeps
constexpr int kNarrowMaxJ = 64;        // keys a lane holds (2048 columns)
constexpr int kWideThreads = 512;      // top-k on wide rows: threads of a row
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideCap = 1024;         // candidates a wide row keeps
constexpr int kSample = 16;            // columns a wide thread samples
constexpr int kBatch = 8;              // a wide thread's loads in flight
constexpr int kWideBlocks = 3;         // wide blocks an SM (40 registers)
constexpr int kTauBits = 12;           // bits of tau searched
constexpr int kEmptyRowToken = -1;
constexpr int kNoIndex = 0x7FFFFFFF;
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr float kTiny = 1.17549435e-38f;  // FLT_MIN
constexpr float kWidth = 1.0f - kTiny;    // uniform's maxval - minval (1.0f)

// which select found a row's kth (select_out)
enum Select { kNoSelect = 0, kCandidates = 1, kWholeRow = 2 };
// the launcher's path option (ops/sampling.py's PATH_*)
enum Path { kPathAuto = 0, kPathNarrow = 1, kPathWide = 2 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

__device__ __forceinline__ void rounds4(uint32_t& x0, uint32_t& x1, int a,
                                        int b, int c, int d) {
  x0 += x1; x1 = rotl(x1, a); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, b); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, c); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, d); x1 ^= x0;
}

// Threefry-2x32, 20 rounds (jax/_src/prng.py :: _threefry2x32_lowering).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0; x1 += k1;
  rounds4(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  rounds4(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  rounds4(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  rounds4(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  rounds4(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
}

__device__ __forceinline__ uint32_t draw_bits(uint32_t s0, uint32_t s1,
                                              unsigned long long i) {
  uint32_t x0 = static_cast<uint32_t>(i >> 32);
  uint32_t x1 = static_cast<uint32_t>(i);
  threefry2x32(s0, s1, x0, x1);
  return x0 ^ x1;
}

__device__ __forceinline__ float gumbel_of(uint32_t bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float u = fmaxf(kTiny, __fmaf_rn(f, kWidth, kTiny));
  return -logf(-logf(u));
}

// The select key of a scaled value: its float bits mapped so that unsigned
// order is float order, with -0 folded into +0 (x + 0.0f) so that equal
// floats get equal keys. Every key of a value is >= 1 (0 marks "no
// column"), NaNs aside.
__device__ __forceinline__ uint32_t select_key(float x) {
  const uint32_t u = __float_as_uint(x + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// The better of two (value, index) candidates: larger value, then lower
// index.
__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    better(v, i, ov, oi);
  }
}

// A bitwise search for the k-th largest of a warp's keys, counted with
// multiplicity: the largest t with count(t) >= k, where count(t) is the
// warp's number of keys >= t (the same on every lane). The caller knows
// lo <= t <= hi (count(lo) >= k; hi is the largest key), so the search
// starts below their common high bits; it stops after ``depth`` bits, with
// the lower bits 0 (a t no larger than the exact one). Every lane of the
// warp takes part and gets the result.
template <class Count>
__device__ __forceinline__ uint32_t kth_search(const Count& count, int k,
                                               uint32_t lo, uint32_t hi,
                                               int depth) {
  const uint32_t diff = lo ^ hi;
  if (diff == 0u) return lo;
  const int top = 31 - __clz(diff);
  uint32_t t = hi & ~((2u << top) - 1u);  // top = 31: 2u << 31 == 0
  const int last = max(top - depth + 1, 0);
  for (int bit = top; bit >= last; --bit) {
    const uint32_t trial = t | (1u << bit);
    if (static_cast<int>(count(trial)) >= k) t = trial;
  }
  return t;
}

// The next round's key, by exactly one thread of the launch; returns the
// draw key in s0, s1.
__device__ __forceinline__ void split_key(const long long* key,
                                          long long* key_out, uint32_t& s0,
                                          uint32_t& s1) {
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  // split(key): counter 0 is the next round's key, counter 1 the draw key
  s0 = 0u;
  s1 = 1u;
  threefry2x32(k0, k1, s0, s1);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    uint32_t n0 = 0u, n1 = 0u;
    threefry2x32(k0, k1, n0, n1);
    key_out[0] = n0;
    key_out[1] = n1;
  }
}

// The raw bits of a row (bits_out), and a dead row's outputs; true when
// the row is live.
__device__ __forceinline__ bool row_start(int b, int V, int first,
                                          int stride, uint32_t s0,
                                          uint32_t s1, const int* lengths,
                                          uint32_t* bits_out, int* tok_out,
                                          int* len_out, int* select_out) {
  const unsigned long long base = static_cast<unsigned long long>(b) * V;
  if (bits_out != nullptr) {
    for (int v = first; v < V; v += stride)
      bits_out[base + v] = draw_bits(s0, s1, base + v);
  }
  if (lengths[b] > 0) return true;
  if (first == 0) {
    tok_out[b] = kEmptyRowToken;
    len_out[b] = 0;
    if (select_out != nullptr) select_out[b] = kNoSelect;
  }
  return false;
}

__device__ __forceinline__ void write_row(int b, int tok, int len, int n_seq,
                                          int eof, int sel, int* tok_out,
                                          int* len_out, int* select_out) {
  const bool finished = tok == eof || len + 1 >= n_seq;
  tok_out[b] = tok;
  len_out[b] = finished ? 0 : len + 1;
  if (select_out != nullptr) select_out[b] = sel;
}

// The block's best (value, index) to thread 0 (a block of kWarps warps).
template <int kWarps>
__device__ __forceinline__ void block_best(float& v, int& i, float* s_val,
                                           int* s_idx) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  warp_best(v, i);
  if (lane == 0) { s_val[warp] = v; s_idx[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? s_val[lane] : -INFINITY;
    i = lane < kWarps ? s_idx[lane] : kNoIndex;
    warp_best(v, i);
  }
}

// ---------------------------------------------------------------- top_k off

// Every column of a live row draws: one block of 1024 threads per row.
__global__ void __launch_bounds__(kAllThreads, 1)
sample_all(const float* __restrict__ logits, long long ld,
           const int* __restrict__ lengths,
           const long long* __restrict__ key, int* __restrict__ tok_out,
           int* __restrict__ len_out, long long* __restrict__ key_out,
           uint32_t* __restrict__ bits_out, int* __restrict__ select_out,
           int V, float tdiv, int n_seq, int eof) {
  __shared__ float s_val[kAllWarps];
  __shared__ int s_idx[kAllWarps];
  const int b = blockIdx.x, tid = threadIdx.x;
  uint32_t s0, s1;
  split_key(key, key_out, s0, s1);
  if (!row_start(b, V, tid, kAllThreads, s0, s1, lengths, bits_out, tok_out,
                 len_out, select_out))
    return;
  const unsigned long long base = static_cast<unsigned long long>(b) * V;
  const float* row = logits + static_cast<long long>(b) * ld;
  float best = -INFINITY;
  int best_i = kNoIndex;
  for (int v = tid; v < V; v += kAllThreads) {
    const float val = gumbel_of(draw_bits(s0, s1, base + v)) + row[v] / tdiv;
    // v grows, so the lowest index wins ties (and a row of -inf gives its
    // first index, as argmax does)
    if (val > best || best_i == kNoIndex) { best = val; best_i = v; }
  }
  block_best<kAllWarps>(best, best_i, s_val, s_idx);
  if (tid == 0)
    write_row(b, best_i, lengths[b], n_seq, eof, kNoSelect, tok_out,
              len_out, select_out);
}

// ---------------------------------------------------------------- narrow

// Top-k, one warp per row, J keys a lane (columns lane + 32 j), V <= 32 J.
template <int J>
__global__ void __launch_bounds__(kNarrowWarps * 32)
sample_narrow(const float* __restrict__ logits, long long ld,
              const int* __restrict__ lengths,
              const long long* __restrict__ key, int* __restrict__ tok_out,
              int* __restrict__ len_out, long long* __restrict__ key_out,
              uint32_t* __restrict__ bits_out, int* __restrict__ select_out,
              int B, int V, float tdiv, int top_k, int n_seq, int eof) {
  __shared__ uint32_t s_ckey[kNarrowWarps][kNarrowCap];
  __shared__ int s_cidx[kNarrowWarps][kNarrowCap];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kNarrowWarps + warp;
  uint32_t s0, s1;
  split_key(key, key_out, s0, s1);
  if (b >= B || !row_start(b, V, lane, 32, s0, s1, lengths, bits_out,
                           tok_out, len_out, select_out))
    return;
  const unsigned long long base = static_cast<unsigned long long>(b) * V;
  const float* row = logits + static_cast<long long>(b) * ld;
  uint32_t* ckey = s_ckey[warp];
  int* cidx = s_cidx[warp];
  // every load in flight before the first division (whose rare slow path
  // is a branch that later loads would not be hoisted above)
  float x[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int v = lane + 32 * j;
    x[j] = v < V ? row[v] : 0.0f;
  }
  uint32_t keys[J];
  uint32_t lmax = 0u, lmin = 0xFFFFFFFFu;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int v = lane + 32 * j;
    keys[j] = v < V ? select_key(x[j] / tdiv) : 0u;
    lmax = max(lmax, keys[j]);
    if (v < V) lmin = min(lmin, keys[j]);
  }
  const uint32_t hi = __reduce_max_sync(kFull, lmax);
  float best = -INFINITY;
  int best_i = kNoIndex;
  int sel = kWholeRow;
  if (top_k <= 32) {
    // tau: the top_k-th largest lane maximum (a lane with no column has
    // 0; tau >= 1 as top_k < V lanes have columns)
    const uint32_t tau = max(kth_search([&](uint32_t t) {
      return __reduce_add_sync(kFull, lmax >= t ? 1u : 0u);
    }, top_k, __reduce_min_sync(kFull, lmax), hi, kTauBits), 1u);
    unsigned c = 0;
#pragma unroll
    for (int j = 0; j < J; ++j) c += keys[j] >= tau ? 1u : 0u;
    unsigned incl = c;
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    const int n = static_cast<int>(__shfl_sync(kFull, incl, 31));
    if (n <= kNarrowCap) {
      int at = static_cast<int>(incl - c);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (keys[j] >= tau) {
          ckey[at] = keys[j];
          cidx[at] = lane + 32 * j;
          ++at;
        }
      }
      __syncwarp();
      const uint32_t kth = kth_search([&](uint32_t t) {
        unsigned m = 0;
        for (int i = lane; i < n; i += 32) m += ckey[i] >= t ? 1u : 0u;
        return __reduce_add_sync(kFull, m);
      }, top_k, tau, hi, 32);
      for (int i = lane; i < n; i += 32) {
        if (ckey[i] < kth) continue;
        const int v = cidx[i];
        better(best, best_i,
               gumbel_of(draw_bits(s0, s1, base + v)) + key_value(ckey[i]),
               v);
      }
      sel = kCandidates;
    }
  }
  if (sel == kWholeRow) {
    // the whole row: the same search over every key of the lanes
    const uint32_t kth = kth_search([&](uint32_t t) {
      unsigned m = 0;
#pragma unroll
      for (int j = 0; j < J; ++j) m += keys[j] >= t ? 1u : 0u;
      return __reduce_add_sync(kFull, m);
    }, top_k, __reduce_min_sync(kFull, lmin), hi, 32);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int v = lane + 32 * j;
      if (v < V && keys[j] >= kth) {
        // v grows, so the lowest index wins ties
        const float val = gumbel_of(draw_bits(s0, s1, base + v)) +
                          key_value(keys[j]);
        if (val > best || best_i == kNoIndex) { best = val; best_i = v; }
      }
    }
  }
  warp_best(best, best_i);
  if (lane == 0)
    write_row(b, best_i, lengths[b], n_seq, eof, sel, tok_out, len_out,
              select_out);
}

// ---------------------------------------------------------------- wide

// f(v, key) for every column v = tid + kWideThreads * j of the row that
// this thread of a wide block holds, in order of v, with the key 0 past
// the row's end; kBatch columns' loads are in flight at once. Every thread
// of the block makes the same calls, so f may use warp collectives.
template <class F>
__device__ __forceinline__ void for_each_key(const float* row, int V,
                                             float tdiv, const F& f) {
  for (int v0 = 0; v0 < V; v0 += kWideThreads * kBatch) {
    float x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int v = v0 + u * kWideThreads + threadIdx.x;
      x[u] = v < V ? row[v] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int v = v0 + u * kWideThreads + threadIdx.x;
      f(v, v < V ? select_key(x[u] / tdiv) : 0u);
    }
  }
}

// Top-k, one block of 512 threads per row, any V.
__global__ void __launch_bounds__(kWideThreads, kWideBlocks)
sample_wide(const float* __restrict__ logits, long long ld,
            const int* __restrict__ lengths,
            const long long* __restrict__ key, int* __restrict__ tok_out,
            int* __restrict__ len_out, long long* __restrict__ key_out,
            uint32_t* __restrict__ bits_out, int* __restrict__ select_out,
            int V, float tdiv, int top_k, int n_seq, int eof) {
  __shared__ uint32_t s_part[kWideThreads];  // the threads' sample maxima
  __shared__ uint32_t s_ckey[kWideCap];
  __shared__ int s_cidx[kWideCap];
  __shared__ unsigned hist[256];
  __shared__ int s_count, s_k;
  __shared__ uint32_t s_tau, s_kth;
  __shared__ float s_val[kWideWarps];
  __shared__ int s_idx[kWideWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  uint32_t s0, s1;
  split_key(key, key_out, s0, s1);
  if (!row_start(b, V, tid, kWideThreads, s0, s1, lengths, bits_out, tok_out,
                 len_out, select_out))
    return;
  const unsigned long long base = static_cast<unsigned long long>(b) * V;
  const float* row = logits + static_cast<long long>(b) * ld;

  // ---- tau from kSample columns a thread, spread over the row ----
  const int cols = (V + kWideThreads - 1) / kWideThreads;  // a thread's
  float xs[kSample];
#pragma unroll
  for (int q = 0; q < kSample; ++q) {
    const int v = tid + kWideThreads * (cols >= kSample ? q * cols / kSample
                                                        : q);
    xs[q] = v < V ? row[v] : 0.0f;
  }
  uint32_t smax = 0u;
#pragma unroll
  for (int q = 0; q < kSample; ++q) {
    const int v = tid + kWideThreads * (cols >= kSample ? q * cols / kSample
                                                        : q);
    if (v < V) smax = max(smax, select_key(xs[q] / tdiv));
  }
  s_part[tid] = smax;
  if (tid == 0) s_count = 0;
  __syncthreads();
  if (warp == 0) {
    uint32_t part[kWideThreads / 32], lo = 0xFFFFFFFFu, hi = 0u;
#pragma unroll
    for (int r = 0; r < kWideThreads / 32; ++r) {
      part[r] = s_part[lane + 32 * r];
      lo = min(lo, part[r]);
      hi = max(hi, part[r]);
    }
    uint32_t tau = 0u;  // 0: no threshold (top_k above the parts)
    if (top_k <= kWideThreads) {
      tau = kth_search([&](uint32_t t) {
        unsigned m = 0;
#pragma unroll
        for (int r = 0; r < kWideThreads / 32; ++r) m += part[r] >= t ? 1u : 0u;
        return __reduce_add_sync(kFull, m);
      }, top_k, __reduce_min_sync(kFull, lo), __reduce_max_sync(kFull, hi),
         kTauBits);
    }
    if (lane == 0) s_tau = tau;
  }
  __syncthreads();
  const uint32_t tau = s_tau;

  // ---- one pass over the row: the candidates >= tau ----
  if (tau != 0u) {
    for_each_key(row, V, tdiv, [&](int v, uint32_t k) {
      const bool hit = k >= tau;
      const unsigned m = __ballot_sync(kFull, hit);
      if (m != 0u) {
        int at = 0;
        if (lane == 0) at = atomicAdd(&s_count, __popc(m));
        at = __shfl_sync(kFull, at, 0) + __popc(m & ((1u << lane) - 1u));
        if (hit && at < kWideCap) {
          s_ckey[at] = k;
          s_cidx[at] = v;
        }
      }
    });
  }
  __syncthreads();
  const int n = s_count;
  const bool whole = tau == 0u || n > kWideCap;
  if (!whole) {
    // ---- the exact kth among the candidates, by one warp ----
    if (warp == 0) {
      uint32_t hi = 0u;
      for (int i = lane; i < n; i += 32) hi = max(hi, s_ckey[i]);
      const uint32_t kth = kth_search([&](uint32_t t) {
        unsigned m = 0;
        for (int i = lane; i < n; i += 32) m += s_ckey[i] >= t ? 1u : 0u;
        return __reduce_add_sync(kFull, m);
      }, top_k, tau, __reduce_max_sync(kFull, hi), 32);
      if (lane == 0) s_kth = kth;
    }
  } else {
    // ---- the exact kth over the whole row: radix select, 8 bits a pass
    uint32_t prefix = 0u, mask = 0u;
    int k = top_k;
    for (int shift = 24; shift >= 0; shift -= 8) {
      if (tid < 256) hist[tid] = 0u;
      __syncthreads();
      for_each_key(row, V, tdiv, [&](int v, uint32_t key_v) {
        const unsigned bin = v < V && (key_v & mask) == prefix
                                 ? (key_v >> shift) & 0xFFu
                                 : 256u;  // 256: no bin
        // one atomicAdd per distinct bin of the warp
        const unsigned peers = __match_any_sync(kFull, bin);
        if (bin < 256u && lane == __ffs(static_cast<int>(peers)) - 1)
          atomicAdd(&hist[bin], static_cast<unsigned>(__popc(peers)));
      });
      __syncthreads();
      if (warp == 0) {
        // lane l holds bins 8l .. 8l+7; above = the counts of all higher
        // lanes' bins (a suffix sum by shuffles)
        unsigned c[8], sum = 0u;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          c[q] = hist[8 * lane + q];
          sum += c[q];
        }
        unsigned incl = sum;
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned y = __shfl_down_sync(kFull, incl, off);
          if (lane + off < 32) incl += y;
        }
        unsigned above = incl - sum;
        const unsigned kk = static_cast<unsigned>(k);
        if (above < kk && kk <= above + sum) {
#pragma unroll
          for (int q = 7; q >= 0; --q) {
            if (above + c[q] >= kk) {
              s_kth = prefix | (static_cast<uint32_t>(8 * lane + q) << shift);
              s_k = static_cast<int>(kk - above);
              break;
            }
            above += c[q];
          }
        }
      }
      __syncthreads();
      prefix = s_kth;
      k = s_k;
      mask |= 0xFFu << shift;
    }
  }
  __syncthreads();
  const uint32_t kth = s_kth;

  // ---- Gumbel-max over the kept columns ----
  float best = -INFINITY;
  int best_i = kNoIndex;
  if (!whole) {
    for (int i = tid; i < n; i += kWideThreads) {
      const uint32_t k = s_ckey[i];
      if (k < kth) continue;
      const int v = s_cidx[i];
      better(best, best_i,
             gumbel_of(draw_bits(s0, s1, base + v)) + key_value(k), v);
    }
  } else {
    for_each_key(row, V, tdiv, [&](int v, uint32_t k) {
      if (v >= V || k < kth) return;
      // v grows, so the lowest index wins ties
      const float val = gumbel_of(draw_bits(s0, s1, base + v)) + key_value(k);
      if (val > best || best_i == kNoIndex) { best = val; best_i = v; }
    });
  }
  block_best<kWideWarps>(best, best_i, s_val, s_idx);
  if (tid == 0)
    write_row(b, best_i, lengths[b], n_seq, eof,
              whole ? kWholeRow : kCandidates, tok_out, len_out, select_out);
}

template <int J>
void launch_narrow(const float* logits, long long ld, const int* lengths,
                   const long long* key, int* tok_out, int* len_out,
                   long long* key_out, uint32_t* bits_out, int* select_out,
                   int B, int V, float tdiv, int top_k, int n_seq, int eof,
                   cudaStream_t s) {
  const int blocks = (B + kNarrowWarps - 1) / kNarrowWarps;
  sample_narrow<J><<<blocks, kNarrowWarps * 32, 0, s>>>(
      logits, ld, lengths, key, tok_out, len_out, key_out, bits_out,
      select_out, B, V, tdiv, top_k, n_seq, eof);
}

}  // namespace

extern "C" {

// The launcher of the kernels above. logits: [B, V] float32 with row
// stride ld (elements); key, key_out: int64 [2] (distinct buffers);
// bits_out and select_out may be NULL. Under top-k (0 < top_k < V), rows
// of at most 32 * kNarrowMaxJ columns run a warp per row, wider ones a
// block per row; path (a check option) forces either: kPathNarrow (an
// error above that width) or kPathWide, else kPathAuto. Returns the
// cudaError_t of the launch (0 = launched).
int mli_sample_next_token(const float* logits, long long ld,
                          const int* lengths, const long long* key,
                          int* tok_out, int* len_out, long long* key_out,
                          unsigned* bits_out, int* select_out, int B, int V,
                          float tdiv, int top_k, int n_seq, int eof,
                          int path, void* stream) {
  if (B <= 0) return 0;
  if (V <= 0 || ld < V || !(tdiv > 0.0f) || path < kPathAuto ||
      path > kPathWide)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = path == kPathNarrow ||
                      (path == kPathAuto && V <= 32 * kNarrowMaxJ);
  if (!(top_k > 0 && top_k < V)) {
    sample_all<<<B, kAllThreads, 0, s>>>(logits, ld, lengths, key, tok_out,
                                         len_out, key_out, bits_out,
                                         select_out, V, tdiv, n_seq, eof);
  } else if (!narrow) {
    sample_wide<<<B, kWideThreads, 0, s>>>(logits, ld, lengths, key, tok_out,
                                           len_out, key_out, bits_out,
                                           select_out, V, tdiv, top_k, n_seq,
                                           eof);
  } else if (V <= 32 * 32) {
    launch_narrow<32>(logits, ld, lengths, key, tok_out, len_out, key_out,
                      bits_out, select_out, B, V, tdiv, top_k, n_seq, eof, s);
  } else if (V <= 32 * kNarrowMaxJ) {
    launch_narrow<kNarrowMaxJ>(logits, ld, lengths, key, tok_out, len_out,
                               key_out, bits_out, select_out, B, V, tdiv,
                               top_k, n_seq, eof, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The widest row that runs a warp per row under top-k.
int mli_sample_narrow_max_v() { return 32 * kNarrowMaxJ; }

const char* mli_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
