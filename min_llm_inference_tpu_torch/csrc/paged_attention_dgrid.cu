// Ring-decode page partial over the full-grant group view, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   min_llm_inference_tpu/ops/paged_attention_dgrid.py ::
//   dgrid_paged_partial (kernel body _dgrid_kernel)
//
// Contract. Under the engine's group allocator a live slot's page-table
// row is gid*W + [0, W), so its context is ONE contiguous [W, 2, P, D]
// range of the pool [NP, 2, P, D] (float32 or int8 with per-page f32
// scales). The pool is read-only and holds positions < ring_start[b] (the
// burst's own rows live in a ring merged outside the kernel). For each live
// slot b and head h, over positions t < ring_start[b]:
//   s_t = (q . K_t) / sqrt(dh) * k_scale(page of t)
//   m = max_t s_t, l = sum_t exp(s_t - m),
//   o = sum_t exp(s_t - m) * v_scale(page of t) * V_t / l     (float32)
// A live slot with ring_start == 0 and a dead slot (lengths == 0) write
// o = 0, m = -inf, l = 0 (the merge's coefficient of an empty partial is
// then exactly 0, never NaN). Dead slots' table rows may hold groups of
// live slots, so nothing of the pool is read for them.
//
// Bound on this card: bytes. A live slot reads ceil(ring_start/P) pages of
// 2*P*D bytes (int8) and does ~4*ring_start*D flops on them, about two
// flops per byte, far below what the card's float32 units do per byte of
// HBM bandwidth. The TPU kernel's mechanisms (group blocks of 32 slots, the
// head-selector dot, scalar-prefetched per-block gating) served its MXU
// and DMA engine and are not carried over. Here:
//   * one block per slot, which reads only its own ceil(ring_start/P)
//     pages, each byte once (no per-block max-width over-read);
//   * the slot's base pointer comes from its group id; token t sits at
//     page t/P, row t%P of the contiguous range;
//   * pass 1: one warp per token computes the H head scores into shared
//     memory (coalesced 4-element loads along the row);
//   * softmax per head over <= W*P scores in shared memory; m and l are
//     written out and the V page scale is folded into the weights;
//   * pass 2: each thread owns VEC contiguous features and walks the
//     tokens, so each token's V row is one coalesced read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction; every thread gets the result. red: kWarps floats.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kWarps; ++i) r = MAX ? fmaxf(r, red[i]) : r + red[i];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

// VEC pool elements at p (VEC-element aligned) as float32.
template <typename E, int VEC>
__device__ __forceinline__ void load_vals(const E* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    if constexpr (sizeof(E) == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else {
      const char4 v = *reinterpret_cast<const char4*>(p);
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    }
  } else {
    x[0] = static_cast<float>(p[0]);
  }
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Dynamic shared memory layout, shared by the host launcher and the kernel.
struct Smem {
  size_t q, scores, l, red, total;
  __host__ __device__ Smem(int D, int H, int Lcap) {
    size_t o = 0;
    q = o;      o += align16(size_t(D) * 4);
    scores = o; o += align16(size_t(H) * Lcap * 4);
    l = o;      o += align16(size_t(H) * 4);
    red = o;    o += align16(size_t(kWarps) * 4);
    total = o;
  }
};

template <typename E, typename TIn, int VEC>
__global__ void __launch_bounds__(kThreads)
dgrid_partial_kernel(const TIn* __restrict__ q, long long q_stride,
                     const E* __restrict__ pool,
                     const float* __restrict__ k_scales,
                     const float* __restrict__ v_scales,
                     const int* __restrict__ ring_start,
                     const int* __restrict__ lengths,
                     const int* __restrict__ table, float* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int D, int NP, int P, int W, int H, float sm_scale) {
  constexpr bool kQuant = sizeof(E) == 1;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dh = D / H;
  const int Lcap = W * P;
  const int L = lengths[b] > 0 ? min(max(ring_start[b], 0), Lcap) : 0;
  float* o = out + static_cast<long long>(b) * D;
  float* mo = m_out + static_cast<long long>(b) * H;
  float* lo = l_out + static_cast<long long>(b) * H;
  if (L == 0) {
    for (int c = tid; c < D; c += kThreads) o[c] = 0.0f;
    for (int h = tid; h < H; h += kThreads) {
      mo[h] = -CUDART_INF_F;
      lo[h] = 0.0f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay(D, H, Lcap);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* sc = reinterpret_cast<float*>(smem + lay.scores);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* red = reinterpret_cast<float*>(smem + lay.red);

  // the slot's group: first page id // W, clamped into the pool
  const int NG = NP / W;
  const int gid = min(max(table[static_cast<long long>(b) * W] / W, 0), NG - 1);
  const int page0 = gid * W;
  const E* base = pool + static_cast<long long>(page0) * 2 * P * D;

  for (int c = tid; c < D; c += kThreads) q_s[c] = to_f32(q[b * q_stride + c]);
  __syncthreads();

  // ---- pass 1: scores, one warp per token ----
  for (int t = warp; t < L; t += kWarps) {
    const E* krow = base + (static_cast<long long>(t / P) * 2 * P + t % P) * D;
    const float ks = kQuant ? k_scales[page0 + t / P] : 1.0f;
    for (int h = 0; h < H; ++h) {
      const E* kh = krow + h * dh;
      const float* qh = q_s + h * dh;
      float acc = 0.0f;
      for (int j = lane * VEC; j < dh; j += 32 * VEC) {
        float x[VEC];
        load_vals<E, VEC>(kh + j, x);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc += qh[j + i] * x[i];
      }
      acc = warp_sum(acc);
      if (lane == 0) sc[h * Lcap + t] = acc * sm_scale * ks;
    }
  }
  __syncthreads();

  // ---- softmax per head; m and l out; V page scales into the weights ----
  for (int h = 0; h < H; ++h) {
    float* s = sc + h * Lcap;
    float m = -CUDART_INF_F;
    for (int t = tid; t < L; t += kThreads) m = fmaxf(m, s[t]);
    m = block_reduce<true>(m, red);
    float l = 0.0f;
    for (int t = tid; t < L; t += kThreads) {
      const float p = expf(s[t] - m);
      l += p;
      s[t] = kQuant ? p * v_scales[page0 + t / P] : p;
    }
    l = block_reduce<false>(l, red);
    if (tid == 0) {
      l_s[h] = l;
      mo[h] = m;
      lo[h] = l;
    }
  }
  __syncthreads();

  // ---- pass 2: o = sum_t w_t V_t / l, each thread VEC features ----
  for (int e0 = tid * VEC; e0 < D; e0 += kThreads * VEC) {
    const int h = e0 / dh;
    const float* w = sc + h * Lcap;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
#pragma unroll 4
    for (int t = 0; t < L; ++t) {
      const E* vrow = base + (static_cast<long long>(t / P) * 2 * P + P + t % P) * D;
      float x[VEC];
      load_vals<E, VEC>(vrow + e0, x);
      const float p = w[t];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += p * x[i];
    }
    const float l = l_s[h];
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[e0 + i] = acc[i] / l;
  }
}

template <typename E, typename TIn>
cudaError_t launch(int vec, const void* q, long long q_stride, const void* pool,
                   const float* k_scales, const float* v_scales,
                   const int* ring_start, const int* lengths, const int* table,
                   float* out, float* m_out, float* l_out, int B, int D,
                   int NP, int P, int W, int H, float sm_scale,
                   cudaStream_t stream) {
  const Smem lay(D, H, W * P);
  auto kernel = vec == 4 ? dgrid_partial_kernel<E, TIn, 4>
                         : dgrid_partial_kernel<E, TIn, 1>;
  if (lay.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(lay.total));
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, kThreads, lay.total, stream>>>(
      static_cast<const TIn*>(q), q_stride, static_cast<const E*>(pool),
      k_scales, v_scales, ring_start, lengths, table, out, m_out, l_out, D, NP,
      P, W, H, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launcher of the kernel above. pool_kind: 0 float32, 1 int8 (then
// k_scales/v_scales are [NP] f32). q is float32 (in_bf16 = 0) or bfloat16
// (in_bf16 = 1) rows with row stride q_stride (elements) and unit inner
// stride. out [B, D], m_out/l_out [B, H] float32. vec is 4 when every
// head's row segment and the pool base are 4-element aligned, else 1.
// Returns the cudaError_t of the launch (0 = launched).
int mli_dgrid_partial(const void* q, long long q_stride, const void* pool,
                      const float* k_scales, const float* v_scales,
                      const int* ring_start, const int* lengths,
                      const int* table, float* out, float* m_out, float* l_out,
                      int B, int D, int NP, int P, int W, int H, int pool_kind,
                      int in_bf16, int vec, float sm_scale, void* stream) {
  if (B <= 0) return 0;
  if (H <= 0 || D % H != 0 || W <= 0 || NP % W != 0 || (vec != 1 && vec != 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLI_LAUNCH(E)                                                        \
  return in_bf16 ? launch<E, __nv_bfloat16>(vec, q, q_stride, pool,         \
                       k_scales, v_scales, ring_start, lengths, table, out, \
                       m_out, l_out, B, D, NP, P, W, H, sm_scale, s)        \
                 : launch<E, float>(vec, q, q_stride, pool, k_scales,       \
                       v_scales, ring_start, lengths, table, out, m_out,    \
                       l_out, B, D, NP, P, W, H, sm_scale, s)
  switch (pool_kind) {
    case 0: MLI_LAUNCH(float);
    case 1: MLI_LAUNCH(int8_t);
    default: return cudaErrorInvalidValue;
  }
#undef MLI_LAUNCH
}

// Shared memory bytes a launch of mli_dgrid_partial needs.
long long mli_dgrid_partial_smem(int D, int H, int W, int P) {
  return static_cast<long long>(Smem(D, H, W * P).total);
}

const char* mli_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
