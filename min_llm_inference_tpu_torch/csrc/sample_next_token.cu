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
// round (written to key_out by block 0), counter 1 the draw key `sub`.
// Row b:
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
// writes its raw bits [B, V].
//
// Bound on this card: the integer arithmetic of threefry (~75 32-bit
// operations an element, every element of every live row) and two logf,
// not the float32 logits read once. One block of 1024 threads per row: the
// 20 rounds run in registers (rotations as funnel shifts) and nothing but
// the row's logits is read. For top-k the scaled row sits in shared memory
// (up to ~56k columns; wider rows are re-read from global memory, where
// they stay in L2) and a radix select over order-preserving float bits
// (four 8-bit passes, a 256-bin histogram in shared memory) finds the
// k-th largest value. A block argmax (warp shuffles, then one warp) picks
// the token.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kEmptyRowToken = -1;
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr float kTiny = 1.17549435e-38f;  // FLT_MIN
constexpr float kWidth = 1.0f - kTiny;    // uniform's maxval - minval (1.0f)

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

// Order-preserving map of float bits to unsigned (larger float, larger key).
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// The better of two (value, index) candidates: larger value, then lower
// index.
__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
}

template <bool kRowInSmem>
__global__ void __launch_bounds__(kThreads, 1)
sample_kernel(const float* __restrict__ logits, long long ld,
              const int* __restrict__ lengths,
              const long long* __restrict__ key, int* __restrict__ tok_out,
              int* __restrict__ len_out, long long* __restrict__ key_out,
              uint32_t* __restrict__ bits_out, int V, float tdiv, int top_k,
              int n_seq, int eof) {
  extern __shared__ float srow[];  // the scaled row (kRowInSmem, top-k)
  __shared__ unsigned hist[256];
  __shared__ uint32_t s_prefix;
  __shared__ int s_k;
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  // split(key): counter 0 is the next round's key, counter 1 the draw key
  uint32_t s0 = 0u, s1 = 1u;
  threefry2x32(k0, k1, s0, s1);
  if (b == 0 && tid == 0) {
    uint32_t n0 = 0u, n1 = 0u;
    threefry2x32(k0, k1, n0, n1);
    key_out[0] = n0;
    key_out[1] = n1;
  }
  const unsigned long long base = static_cast<unsigned long long>(b) * V;
  if (bits_out != nullptr) {
    for (int v = tid; v < V; v += kThreads)
      bits_out[base + v] = draw_bits(s0, s1, base + v);
  }
  const int len = lengths[b];
  if (len <= 0) {
    if (tid == 0) {
      tok_out[b] = kEmptyRowToken;
      len_out[b] = 0;
    }
    return;
  }
  const float* row = logits + static_cast<long long>(b) * ld;
  const bool use_topk = top_k > 0 && top_k < V;
  const bool cached = kRowInSmem && use_topk;
  if (cached) {
    for (int v = tid; v < V; v += kThreads) srow[v] = row[v] / tdiv;
    __syncthreads();
  }

  // ---- top-k threshold: radix select of the top_k-th largest key ----
  float kth = -INFINITY;
  if (use_topk) {
    uint32_t prefix = 0u, mask = 0u;
    int k = top_k;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = tid; i < 256; i += kThreads) hist[i] = 0u;
      __syncthreads();
      for (int v = tid; v < V; v += kThreads) {
        const uint32_t key_v = order_key(cached ? srow[v] : row[v] / tdiv);
        if ((key_v & mask) == prefix)
          atomicAdd(&hist[(key_v >> shift) & 0xFFu], 1u);
      }
      __syncthreads();
      if (tid == 0) {
        int above = 0;
        for (int d = 255; d >= 0; --d) {
          const int c = static_cast<int>(hist[d]);
          if (above + c >= k) {
            s_prefix = prefix | (static_cast<uint32_t>(d) << shift);
            s_k = k - above;
            break;
          }
          above += c;
        }
      }
      __syncthreads();
      prefix = s_prefix;
      k = s_k;
      mask |= 0xFFu << shift;
    }
    kth = from_order_key(prefix);
  }

  // ---- Gumbel-max over the kept columns ----
  float best = -INFINITY;
  int best_i = 0x7FFFFFFF;
  for (int v = tid; v < V; v += kThreads) {
    const float x = cached ? srow[v] : row[v] / tdiv;
    if (use_topk && !(x >= kth)) continue;
    const float val = gumbel_of(draw_bits(s0, s1, base + v)) + x;
    // v grows, so the lowest index wins ties (and a row of -inf gives its
    // first kept index, as argmax does)
    if (val > best || best_i == 0x7FFFFFFF) { best = val; best_i = v; }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xFFFFFFFFu, best, off);
    const int oi = __shfl_down_sync(0xFFFFFFFFu, best_i, off);
    better(best, best_i, ov, oi);
  }
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) { s_val[warp] = best; s_idx[warp] = best_i; }
  __syncthreads();
  if (warp == 0) {
    best = s_val[lane];
    best_i = s_idx[lane];
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xFFFFFFFFu, best, off);
      const int oi = __shfl_down_sync(0xFFFFFFFFu, best_i, off);
      better(best, best_i, ov, oi);
    }
    if (lane == 0) {
      const bool finished = best_i == eof || len + 1 >= n_seq;
      tok_out[b] = best_i;
      len_out[b] = finished ? 0 : len + 1;
    }
  }
}

}  // namespace

extern "C" {

// The launcher of the kernel above. logits: [B, V] float32 with row stride
// ld (elements); key, key_out: int64 [2] (distinct buffers); bits_out may be
// NULL. smem_row = 1 keeps the scaled row in dynamic shared memory for
// top-k (V * 4 bytes must fit beside the kernel's static shared memory).
// Returns the cudaError_t of the launch (0 = launched).
int mli_sample_next_token(const float* logits, long long ld,
                          const int* lengths, const long long* key,
                          int* tok_out, int* len_out, long long* key_out,
                          unsigned* bits_out, int B, int V, float tdiv,
                          int top_k, int n_seq, int eof, int smem_row,
                          void* stream) {
  if (B <= 0) return 0;
  if (V <= 0 || ld < V || !(tdiv > 0.0f)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem_row) {
    const int smem = V * static_cast<int>(sizeof(float));
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          sample_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return err;
    }
    sample_kernel<true><<<B, kThreads, smem, s>>>(
        logits, ld, lengths, key, tok_out, len_out, key_out, bits_out, V,
        tdiv, top_k, n_seq, eof);
  } else {
    sample_kernel<false><<<B, kThreads, 0, s>>>(
        logits, ld, lengths, key, tok_out, len_out, key_out, bits_out, V,
        tdiv, top_k, n_seq, eof);
  }
  return cudaGetLastError();
}

const char* mli_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
