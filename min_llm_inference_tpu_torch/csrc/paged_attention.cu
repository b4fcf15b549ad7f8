// One-slot paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   min_llm_inference_tpu/ops/paged_attention.py ::
//   paged_decode_attention (kernel body _paged_decode_kernel),
// the attention of the host-scheduled PagedEngine (attention_impl="paged").
//
// What it computes, for each slot b with L = min(lengths[b], W*P) > 0:
//   K[t] = pool[table[b, t/P], 0, t%P] * k_scale[table[b, t/P]]  (int8)
//   V[t] likewise with side 1 and v_scale (float32 pools: no scale)
//   o[b, h] = softmax_t(q[b, h] . K[t, h] / sqrt(dh)) . V[t, h], t < L
// as float32. Rows are dequantized before the dots, as the JAX kernel
// does. Dead slots (L == 0) read nothing and output exact zeros: the host
// scheduler never clears a freed slot's table row, so a dead slot's row
// may hold page ids that now belong to a live slot. Page ids are clamped
// into the pool. The table may be fragmented (any page id per entry): the
// kernel reads table[b, t/P] per token and assumes no contiguous run.
//
// Bound on this card: bytes. A live slot reads L K rows and L V rows of D
// elements once (int8 at the main path's shapes: 1024 slots, W*P = 128,
// D = 2048, one head) and does ~4*L*D flops on them, about 2 flops per
// byte -- far below the H100's ~20 f32 flops per byte of HBM bandwidth.
// So the design reads every pool byte once, with wide loads, and keeps the
// rest on chip:
//   * one block of 256 threads per slot (1024 slots: ~8 blocks per SM);
//   * q (8 KB of f32 at D = 2048) lives in shared memory, not registers:
//     head dim 2048 does not fit a thread;
//   * pass 1: one warp per token, 16-byte loads along the row (16 int8 or
//     4 f32 per lane per load), warp-reduced per head into shared scores;
//   * softmax per head over the <= W*P scores in shared memory;
//   * pass 2: each thread owns one 16-byte chunk of the row and walks a
//     share of the tokens (at D = 2048 int8: 128 chunks, so two token
//     groups of 128 threads), the groups' partial sums meet in shared
//     memory.
// The TPU mechanisms (scalar prefetch, double-buffered page DMAs, the
// dead-slot walk, the VMEM block chooser) have no counterpart here: a
// block loads its own page ids and the hardware overlaps the loads of the
// 8 resident blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum PoolKind { kF32 = 0, kI8 = 1 };

template <int KIND> struct Elem { using T = int8_t; };
template <> struct Elem<kF32> { using T = float; };

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

// N storage elements at p (N-element aligned) as floats: one 16-byte load
// (N = 16 int8 or 4 f32) or one element (N = 1).
template <int KIND, int N>
__device__ __forceinline__ void load_vals(const typename Elem<KIND>::T* p,
                                          float (&x)[N]) {
  if constexpr (N == 1) {
    x[0] = static_cast<float>(p[0]);
  } else if constexpr (KIND == kF32) {
    static_assert(N == 4, "16-byte f32 loads hold 4 elements");
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    static_assert(N == 16, "16-byte int8 loads hold 16 elements");
    union { int4 v; int8_t b[16]; } u;
    u.v = *reinterpret_cast<const int4*>(p);
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = static_cast<float>(u.b[i]);
  }
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Token groups of pass 2: with fewer N-element chunks in a row than
// threads, kThreads / chunks groups of threads walk the tokens in turn.
__host__ __device__ inline int token_groups(int D, int N) {
  const int chunks = D / N;
  return chunks >= kThreads ? 1 : kThreads / chunks;
}

// Dynamic shared memory layout, shared by the host launcher and the kernel.
struct Smem {
  size_t q, scores, tok_off, tok_ks, tok_vs, l, red, part, total;
  __host__ __device__ Smem(int D, int H, int Lcap, int N) {
    const int groups = token_groups(D, N);
    size_t o = 0;
    q = o;       o += align16(size_t(D) * 4);
    scores = o;  o += align16(size_t(H) * Lcap * 4);
    tok_off = o; o += align16(size_t(Lcap) * 8);
    tok_ks = o;  o += align16(size_t(Lcap) * 4);
    tok_vs = o;  o += align16(size_t(Lcap) * 4);
    l = o;       o += align16(size_t(H) * 4);
    red = o;     o += align16(size_t(kWarps) * 4);
    part = o;    o += groups > 1 ? align16(size_t(groups) * D * 4) : 0;
    total = o;
  }
};

template <int KIND, typename TIn, int N>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TIn* __restrict__ q, long long q_stride,
                       const typename Elem<KIND>::T* __restrict__ pool,
                       const int* __restrict__ lengths,
                       const int* __restrict__ table,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       float* __restrict__ out, int D, int NP, int P, int W,
                       int H, float sm_scale) {
  using E = typename Elem<KIND>::T;
  constexpr bool kQuant = KIND != kF32;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dh = D / H;
  const int Lcap = W * P;
  const int L = min(max(lengths[b], 0), Lcap);
  float* o = out + static_cast<long long>(b) * D;
  if (L == 0) {
    for (int c = tid; c < D; c += kThreads) o[c] = 0.0f;
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay(D, H, Lcap, N);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* sc = reinterpret_cast<float*>(smem + lay.scores);
  long long* tok_off = reinterpret_cast<long long*>(smem + lay.tok_off);
  float* tok_ks = reinterpret_cast<float*>(smem + lay.tok_ks);
  float* tok_vs = reinterpret_cast<float*>(smem + lay.tok_vs);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* part = reinterpret_cast<float*>(smem + lay.part);

  for (int c = tid; c < D; c += kThreads) q_s[c] = to_f32(q[b * q_stride + c]);
  for (int t = tid; t < L; t += kThreads) {
    const int pid =
        min(max(table[static_cast<long long>(b) * W + t / P], 0), NP - 1);
    tok_off[t] = (static_cast<long long>(pid) * 2 * P + t % P) * D;
    tok_ks[t] = kQuant ? k_scales[pid] : 1.0f;
    tok_vs[t] = kQuant ? v_scales[pid] : 1.0f;
  }
  __syncthreads();

  // ---- pass 1: scores over dequantized K rows, one warp per token ----
  for (int t = warp; t < L; t += kWarps) {
    const E* krow = pool + tok_off[t];
    const float ks = tok_ks[t];
    for (int h = 0; h < H; ++h) {
      const E* kh = krow + h * dh;
      const float* qh = q_s + h * dh;
      float acc = 0.0f;
#pragma unroll 4
      for (int j = lane * N; j < dh; j += 32 * N) {
        float x[N];
        load_vals<KIND, N>(kh + j, x);
#pragma unroll
        for (int i = 0; i < N; ++i) acc += qh[j + i] * (x[i] * ks);
      }
      acc = warp_sum(acc);
      if (lane == 0) sc[h * Lcap + t] = acc * sm_scale;
    }
  }
  __syncthreads();

  // ---- softmax per head: sc becomes exp(s - m), l_s the sums ----
  for (int h = 0; h < H; ++h) {
    float* s = sc + h * Lcap;
    float m = -CUDART_INF_F;
    for (int t = tid; t < L; t += kThreads) m = fmaxf(m, s[t]);
    m = block_reduce<true>(m, red);
    float l = 0.0f;
    for (int t = tid; t < L; t += kThreads) {
      const float p = expf(s[t] - m);
      l += p;
      s[t] = p;
    }
    l = block_reduce<false>(l, red);
    if (tid == 0) l_s[h] = l;
  }
  __syncthreads();

  // ---- pass 2: o = sum_t p_t V_t / l over dequantized V rows ----
  const int chunks = D / N;
  const int groups = token_groups(D, N);
  int g = 0, c0 = tid, cstep = kThreads;
  if (groups > 1) {
    g = tid / chunks;
    c0 = g < groups ? tid % chunks : chunks;  // surplus threads idle
    cstep = chunks;
  }
  for (int c = c0; c < chunks; c += cstep) {
    const int e0 = c * N;
    const int h = e0 / dh;  // a chunk never straddles two heads
    const float* w = sc + h * Lcap;
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.0f;
#pragma unroll 4
    for (int t = g; t < L; t += groups) {
      float x[N];
      load_vals<KIND, N>(pool + tok_off[t] + size_t(P) * D + e0, x);
      const float p = w[t];
      const float vs = tok_vs[t];
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += p * (x[i] * vs);
    }
    if (groups == 1) {
      const float l = l_s[h];
#pragma unroll
      for (int i = 0; i < N; ++i) o[e0 + i] = acc[i] / l;
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) part[g * D + e0 + i] = acc[i];
    }
  }
  if (groups > 1) {
    __syncthreads();
    for (int e = tid; e < D; e += kThreads) {
      float s = 0.0f;
      for (int gg = 0; gg < groups; ++gg) s += part[gg * D + e];
      o[e] = s / l_s[e / dh];
    }
  }
}

template <int KIND, typename TIn, int N>
cudaError_t launch(const void* q, long long q_stride, const void* pool,
                   const int* lengths, const int* table, const float* k_scales,
                   const float* v_scales, float* out, int B, int D, int NP,
                   int P, int W, int H, float sm_scale, cudaStream_t stream) {
  using E = typename Elem<KIND>::T;
  const Smem lay(D, H, W * P, N);
  auto kernel = paged_attention_kernel<KIND, TIn, N>;
  if (lay.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(lay.total));
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, kThreads, lay.total, stream>>>(
      static_cast<const TIn*>(q), q_stride, static_cast<const E*>(pool),
      lengths, table, k_scales, v_scales, out, D, NP, P, W, H, sm_scale);
  return cudaGetLastError();
}

template <int KIND, typename TIn>
cudaError_t dispatch_vec(int vec16, const void* q, long long q_stride,
                         const void* pool, const int* lengths, const int* table,
                         const float* k_scales, const float* v_scales,
                         float* out, int B, int D, int NP, int P, int W, int H,
                         float sm_scale, cudaStream_t stream) {
  constexpr int kVec = KIND == kF32 ? 4 : 16;
  if (vec16)
    return launch<KIND, TIn, kVec>(q, q_stride, pool, lengths, table, k_scales,
                                   v_scales, out, B, D, NP, P, W, H, sm_scale,
                                   stream);
  return launch<KIND, TIn, 1>(q, q_stride, pool, lengths, table, k_scales,
                              v_scales, out, B, D, NP, P, W, H, sm_scale,
                              stream);
}

int vec_elems(int pool_kind, int vec16) {
  return vec16 ? (pool_kind == kF32 ? 4 : 16) : 1;
}

}  // namespace

extern "C" {

// The launcher of the kernel above. pool_kind: 0 float32, 1 int8 (then
// k_scales/v_scales [NP] are required). q is float32 (in_bf16 = 0) or
// bfloat16 (in_bf16 = 1) rows of the given row stride (elements) with unit
// inner stride. vec16 = 1 when the pool base and every head's row segment
// are 16-byte aligned (16-byte loads), else 0. Returns the cudaError_t of
// the launch (0 = launched).
int mli_paged_attention(const void* q, long long q_stride, const void* pool,
                        const int* lengths, const int* table,
                        const float* k_scales, const float* v_scales,
                        float* out, int B, int D, int NP, int P, int W, int H,
                        int pool_kind, int in_bf16, int vec16, float sm_scale,
                        void* stream) {
  if (B <= 0) return 0;
  if (H <= 0 || D % H != 0 || NP <= 0 || P <= 0 || W <= 0)
    return cudaErrorInvalidValue;
  if ((D / H) % vec_elems(pool_kind, vec16) != 0) return cudaErrorInvalidValue;
  if (pool_kind == kI8 && (k_scales == nullptr || v_scales == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLI_DISPATCH(KIND)                                                   \
  return in_bf16                                                             \
      ? dispatch_vec<KIND, __nv_bfloat16>(vec16, q, q_stride, pool, lengths, \
            table, k_scales, v_scales, out, B, D, NP, P, W, H, sm_scale, s)  \
      : dispatch_vec<KIND, float>(vec16, q, q_stride, pool, lengths, table,  \
            k_scales, v_scales, out, B, D, NP, P, W, H, sm_scale, s)
  switch (pool_kind) {
    case kF32: MLI_DISPATCH(kF32);
    case kI8: MLI_DISPATCH(kI8);
    default: return cudaErrorInvalidValue;
  }
#undef MLI_DISPATCH
}

// Shared memory bytes a launch of mli_paged_attention needs.
long long mli_paged_attention_smem(int D, int H, int W, int P, int pool_kind,
                                   int vec16) {
  return static_cast<long long>(
      Smem(D, H, W * P, vec_elems(pool_kind, vec16)).total);
}

const char* mli_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
