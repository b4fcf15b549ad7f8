// Cross-slot ("flat") ring partial of paged decode attention, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   min_llm_inference_tpu/ops/paged_attention_flat.py ::
//   paged_decode_attention_flat (kernel body _flat_kernel)
//
// What it computes. The pool [NP, 2, P, Dk] (float32, int8, or packed int4
// with Dk = D/2; int8/int4 with per-page f32 scales) is read-only and holds
// positions < ring_start[b] (the burst's own rows live in a ring merged
// outside the kernel). For each live slot b (lengths[b] > 0) and head h,
// over positions t < ring_start[b]:
//   s_t = (q . K_t) / sqrt(dh) * k_scale(page of t)
//   m = max_t s_t, l = sum_t exp(s_t - m),
//   o = sum_t exp(s_t - m) * v_scale(page of t) * V_t / l     (float32)
// A dead slot (lengths == 0, whatever its ring_start) and a live slot with
// ring_start == 0 write o = 0, m = -inf, l = 0: the merge's coefficient of
// an empty partial is then exactly 0, never NaN.
//
// The table. Token t of slot b sits in page table[b, t / P] (clamped into
// the pool), row t % P. Nothing assumes that a row's pages are contiguous:
// under overcommit a row is two independent half-groups, and an ungrown
// row's second half repeats its first (its positions never reach there).
//
// The TPU kernel's point is cross-slot work: G slots' rows form one flat
// row tile, so the work per block does not depend on how the lengths split
// across the slots. This kernel keeps that structure, not the TPU's block
// mechanics (selector dots, plane transforms of q, DMA runs):
//   * one block per group of kGroup slots; the valid rows of the group
//     (slot j's positions < its ring_start) form one flat index space,
//     whose prefix sum over the slots sits in shared memory with the
//     slots' page ids and their q rows;
//   * pass 1: warps take flat rows regardless of slot, score all heads of
//     a row (4-element loads along the row) into shared memory;
//   * a segmented max / sum per (slot, head), one warp per segment; m and
//     l go out and the V page scale is folded into the weights;
//   * pass 2: each thread owns VEC storage elements of the row and walks
//     the flat rows in order, flushing its accumulator (divided by l) at
//     each slot boundary. When a row needs fewer threads than the block
//     has, the block's thread groups take interleaved slots.
// int4 is unpacked in registers as the port packs it (ops/quant.py):
// byte = 16*hi + lo per head, hi = rint(byte/16), lo = byte - 16*hi.
//
// Bound on this card: bytes. A live slot reads ceil(ring_start/P) pages of
// 2*P*Dk bytes once and does ~4*ring_start*D flops on them, a few flops per
// byte, far below what the card's float32 units do per byte of HBM
// bandwidth. Every pool byte is read at most once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;  // slots per block

enum PoolKind { kF32 = 0, kI8 = 1, kI4 = 2 };

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

// VEC storage elements at p -> lo[] (the value, or the int4 lo nibble) and
// hi[] (the int4 hi nibble). p is VEC-element aligned.
template <int KIND, int VEC>
__device__ __forceinline__ void load_vals(const typename Elem<KIND>::T* p,
                                          float (&lo)[VEC], float (&hi)[VEC]) {
  if constexpr (KIND == kF32) {
    if constexpr (VEC == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      lo[0] = v.x; lo[1] = v.y; lo[2] = v.z; lo[3] = v.w;
    } else {
      lo[0] = p[0];
    }
  } else {
    int8_t b[VEC];
    if constexpr (VEC == 4) {
      const char4 v = *reinterpret_cast<const char4*>(p);
      b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
    } else {
      b[0] = p[0];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float f = static_cast<float>(b[i]);
      if constexpr (KIND == kI4) {
        hi[i] = rintf(f * 0.0625f);
        lo[i] = f - 16.0f * hi[i];
      } else {
        lo[i] = f;
      }
    }
  }
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Dynamic shared memory layout, shared by the host launcher and the kernel.
// Ncap = kGroup * W * P flat rows at most.
struct Smem {
  size_t off, pages, q, scores, l, total;
  __host__ __device__ Smem(int D, int H, int W, int P) {
    const size_t ncap = size_t(kGroup) * W * P;
    size_t o = 0;
    off = o;    o += align16(size_t(kGroup + 1) * 4);
    pages = o;  o += align16(size_t(kGroup) * W * 4);
    q = o;      o += align16(size_t(kGroup) * D * 4);
    scores = o; o += align16(size_t(H) * ncap * 4);
    l = o;      o += align16(size_t(kGroup) * H * 4);
    total = o;
  }
};

// The slot of flat row r: the last j with off[j] <= r.
__device__ __forceinline__ int slot_of(int r, const int* off, int nslots) {
  int j = 0;
  while (j + 1 < nslots && off[j + 1] <= r) ++j;
  return j;
}

template <int KIND, typename TIn, int VEC>
__global__ void __launch_bounds__(kThreads)
flat_partial_kernel(const TIn* __restrict__ q, long long q_stride,
                    const typename Elem<KIND>::T* __restrict__ pool,
                    const int* __restrict__ lengths,
                    const int* __restrict__ table,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ ring_start,
                    float* __restrict__ out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int B, int D, int NP, int P,
                    int W, int H, float sm_scale) {
  using E = typename Elem<KIND>::T;
  constexpr bool kQuant = KIND != kF32;
  constexpr bool kPacked = KIND == kI4;
  const int b0 = blockIdx.x * kGroup;
  const int nslots = min(kGroup, B - b0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Dk = kPacked ? D / 2 : D;
  const int dh = D / H;
  const int dhk = Dk / H;  // storage elements per head
  const int Lcap = W * P;
  const int ncap = kGroup * Lcap;

  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay(D, H, W, P);
  int* off = reinterpret_cast<int*>(smem + lay.off);
  int* pg = reinterpret_cast<int*>(smem + lay.pages);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* sc = reinterpret_cast<float*>(smem + lay.scores);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);

  // ---- the group's flat row space, page ids and q rows ----
  if (tid == 0) {
    off[0] = 0;
    for (int j = 0; j < kGroup; ++j) {
      int n = 0;
      if (j < nslots && lengths[b0 + j] > 0)
        n = min(max(ring_start[b0 + j], 0), Lcap);
      off[j + 1] = off[j] + n;
    }
  }
  for (int i = tid; i < nslots * W; i += kThreads) {
    const int j = i / W;
    pg[i] = min(max(table[static_cast<long long>(b0 + j) * W + i % W], 0), NP - 1);
  }
  for (int i = tid; i < nslots * D; i += kThreads) {
    const int j = i / D;
    q_s[i] = to_f32(q[(b0 + j) * q_stride + i % D]);
  }
  __syncthreads();
  const int N = off[kGroup];

  // empty slots (dead, or all of their context in the ring)
  for (int j = 0; j < nslots; ++j) {
    if (off[j + 1] > off[j]) continue;
    const long long b = b0 + j;
    for (int c = tid; c < D; c += kThreads) out[b * D + c] = 0.0f;
    for (int h = tid; h < H; h += kThreads) {
      m_out[b * H + h] = -CUDART_INF_F;
      l_out[b * H + h] = 0.0f;
    }
  }
  if (N == 0) return;

  // ---- pass 1: scores of every head, one warp per flat row ----
  for (int r = warp; r < N; r += kWarps) {
    const int j = slot_of(r, off, nslots);
    const int t = r - off[j];
    const int page = pg[j * W + t / P];
    const E* krow = pool + (static_cast<long long>(page) * 2 * P + t % P) * Dk;
    const float ks = kQuant ? k_scales[page] : 1.0f;
    const float* qj = q_s + j * D;
    for (int h = 0; h < H; ++h) {
      const E* kh = krow + h * dhk;
      const float* qh = qj + h * dh;
      float acc = 0.0f;
      for (int e = lane * VEC; e < dhk; e += 32 * VEC) {
        float lo[VEC], hi[VEC];
        load_vals<KIND, VEC>(kh + e, lo, hi);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          acc += qh[e + i] * lo[i];
          if constexpr (kPacked) acc += qh[dhk + e + i] * hi[i];
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) sc[h * ncap + r] = acc * ks * sm_scale;
    }
  }
  __syncthreads();

  // ---- segmented softmax statistics, one warp per (slot, head) ----
  for (int seg = warp; seg < nslots * H; seg += kWarps) {
    const int j = seg / H, h = seg - j * H;
    const int lo = off[j], hi = off[j + 1];
    if (lo == hi) continue;
    float* s = sc + h * ncap;
    float m = -CUDART_INF_F;
    for (int r = lo + lane; r < hi; r += 32) m = fmaxf(m, s[r]);
    m = warp_max(m);
    float l = 0.0f;
    for (int r = lo + lane; r < hi; r += 32) {
      const float p = expf(s[r] - m);
      l += p;
      s[r] = kQuant ? p * v_scales[pg[j * W + (r - lo) / P]] : p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      const long long b = b0 + j;
      l_s[j * H + h] = l;
      m_out[b * H + h] = m;
      l_out[b * H + h] = l;
    }
  }
  __syncthreads();

  // ---- pass 2: o = sum_t w_t V_t / l; VEC storage elements a thread,
  // flat rows in order, one flush per slot boundary ----
  const int chunks = Dk / VEC;
  const int groups = max(1, kThreads / chunks);
  for (int task = tid; task < groups * chunks; task += kThreads) {
    const int grp = task / chunks;
    const int e0 = (task - grp * chunks) * VEC;
    const int h = e0 / dhk, j0 = e0 - h * dhk;
    const float* w = sc + h * ncap;
    for (int j = grp; j < nslots; j += groups) {
      const int lo = off[j], hi = off[j + 1];
      if (lo == hi) continue;
      float acc_lo[VEC], acc_hi[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc_lo[i] = acc_hi[i] = 0.0f;
#pragma unroll 4
      for (int r = lo; r < hi; ++r) {
        const int t = r - lo;
        const int page = pg[j * W + t / P];
        const E* vrow = pool + ((static_cast<long long>(page) * 2 + 1) * P + t % P) * Dk;
        float vl[VEC], vh[VEC];
        load_vals<KIND, VEC>(vrow + e0, vl, vh);
        const float p = w[r];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          acc_lo[i] += p * vl[i];
          if constexpr (kPacked) acc_hi[i] += p * vh[i];
        }
      }
      const float l = l_s[j * H + h];
      float* o = out + static_cast<long long>(b0 + j) * D;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if constexpr (kPacked) {
          o[h * dh + j0 + i] = acc_lo[i] / l;
          o[h * dh + dhk + j0 + i] = acc_hi[i] / l;
        } else {
          o[e0 + i] = acc_lo[i] / l;
        }
      }
    }
  }
}

template <int KIND, typename TIn>
cudaError_t launch(int vec, const void* q, long long q_stride, const void* pool,
                   const int* lengths, const int* table, const float* k_scales,
                   const float* v_scales, const int* ring_start, float* out,
                   float* m_out, float* l_out, int B, int D, int NP, int P,
                   int W, int H, float sm_scale, cudaStream_t stream) {
  using E = typename Elem<KIND>::T;
  const Smem lay(D, H, W, P);
  auto kernel = vec == 4 ? flat_partial_kernel<KIND, TIn, 4>
                         : flat_partial_kernel<KIND, TIn, 1>;
  if (lay.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(lay.total));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (B + kGroup - 1) / kGroup;
  kernel<<<blocks, kThreads, lay.total, stream>>>(
      static_cast<const TIn*>(q), q_stride, static_cast<const E*>(pool),
      lengths, table, k_scales, v_scales, ring_start, out, m_out, l_out, B, D,
      NP, P, W, H, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launcher of the kernel above. pool_kind: 0 float32, 1 int8, 2 packed
// int4 (int8 storage, Dk = D/2); int8 and int4 take k_scales/v_scales [NP]
// f32. q is float32 (in_bf16 = 0) or bfloat16 (in_bf16 = 1) rows with row
// stride q_stride (elements) and unit inner stride. out [B, D], m_out and
// l_out [B, H] float32. vec is 4 when every head's row segment and the pool
// base are 4-element aligned, else 1. Returns the cudaError_t of the launch
// (0 = launched).
int mli_flat_partial(const void* q, long long q_stride, const void* pool,
                     const int* lengths, const int* table,
                     const float* k_scales, const float* v_scales,
                     const int* ring_start, float* out, float* m_out,
                     float* l_out, int B, int D, int NP, int P, int W, int H,
                     int pool_kind, int in_bf16, int vec, float sm_scale,
                     void* stream) {
  if (B <= 0) return 0;
  if (H <= 0 || D % H != 0 || W <= 0 || P <= 0 || (vec != 1 && vec != 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLI_LAUNCH(KIND)                                                     \
  return in_bf16 ? launch<KIND, __nv_bfloat16>(vec, q, q_stride, pool,      \
                       lengths, table, k_scales, v_scales, ring_start, out, \
                       m_out, l_out, B, D, NP, P, W, H, sm_scale, s)        \
                 : launch<KIND, float>(vec, q, q_stride, pool, lengths,     \
                       table, k_scales, v_scales, ring_start, out, m_out,   \
                       l_out, B, D, NP, P, W, H, sm_scale, s)
  switch (pool_kind) {
    case kF32: MLI_LAUNCH(kF32);
    case kI8: MLI_LAUNCH(kI8);
    case kI4: MLI_LAUNCH(kI4);
    default: return cudaErrorInvalidValue;
  }
#undef MLI_LAUNCH
}

// Shared memory bytes a launch of mli_flat_partial needs.
long long mli_flat_partial_smem(int D, int H, int W, int P) {
  return static_cast<long long>(Smem(D, H, W, P).total);
}

const char* mli_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
