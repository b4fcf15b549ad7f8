// Fused-write paged decode attention and ring partial for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   min_llm_inference_tpu/ops/paged_attention_grouped.py ::
//   paged_decode_attention_grouped (kernel body _grouped_kernel)
// in its plain mode (a), its fused-write mode (b) and its ring-partial
// mode (c).
//
// What it computes, for each slot b with L = lengths[b] > 0:
//   (b only) quantize the raw new K and V rows against the ALREADY UPDATED
//   page scales, s > 0 ? clip(rint(x * (1/max(s, 1e-30))), +-qmax) : 0,
//   pack int4 per head as 16*hi + lo, and write the row in place into
//   pool[table[b, (L-1)/P], side, (L-1)%P];
//   o[b] = softmax_h(q . K[0:L]^T / sqrt(dh)) . V[0:L] as float32, over
//   the dequantized (page-scaled) K/V, the row just written included.
// Dead slots (L == 0) write nothing and output exact zeros; their table
// rows may hold page ids of live slots, so every read and write is gated
// on L.
// (c) the pool is read-only and holds positions < ring_start[b] (the
//   burst's own rows live in a ring merged outside the kernel): the block
//   attends over positions [0, ring_start) of a live slot and writes the
//   online-softmax partial o (normalized), m = max score, l = sum of
//   exp(score - m) per head. A live slot with ring_start == 0 and a dead
//   slot write o = 0, m = -inf, l = 0 (the merge's coefficient of an empty
//   partial is then exactly 0, never NaN).
//
// Bound on this card: bytes. Each live slot reads L K rows and L V rows of
// Dk bytes (int4: D/2) once and does ~4*L*D flops on them, about one flop
// per byte -- far below the H100's ~20 flops/byte (fp32 CUDA cores at
// 3.35 TB/s). The design therefore reads every pool byte exactly once and
// keeps everything else on chip:
//   * one block per slot (the main path has 1024 slots: ~8 blocks per SM);
//   * the new row is quantized once and kept in shared memory, so the
//     block never reads back its own global write;
//   * pass 1: one warp per token computes the H head scores into shared
//     memory (coalesced 4-element loads along the row);
//   * softmax over the <= W*P scores in shared memory; the V page scale is
//     folded into the probabilities;
//   * pass 2: each thread owns VEC contiguous storage elements of the row
//     and walks the tokens, so each token's V row is one coalesced read.
// int4 is unpacked in registers: hi = rint(b/16), lo = b - 16*hi (exact).
// Quantization uses IEEE division and rintf (round half to even): built
// without --use_fast_math, it gives the bytes of the plain version and of
// the JAX quantizer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum PoolKind { kF32 = 0, kI8 = 1, kI4 = 2 };
enum Mode { kPlain = 0, kFused = 1, kRing = 2 };

template <int KIND> struct Elem { using T = int8_t; };
template <> struct Elem<kF32> { using T = float; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float quant(float x, float inv, float qmax) {
  return fminf(fmaxf(rintf(x * inv), -qmax), qmax);
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
struct Smem {
  size_t new_rows, q, scores, tok_off, tok_page, l, red, total;
  __host__ __device__ Smem(int D, int Dk, int H, int Lcap, int elem_bytes) {
    size_t o = 0;
    new_rows = o; o += align16(size_t(2) * Dk * elem_bytes);
    q = o;        o += align16(size_t(D) * 4);
    scores = o;   o += align16(size_t(H) * Lcap * 4);
    tok_off = o;  o += align16(size_t(Lcap) * 8);
    tok_page = o; o += align16(size_t(Lcap) * 4);
    l = o;        o += align16(size_t(H) * 4);
    red = o;      o += align16(size_t(kWarps) * 4);
    total = o;
  }
};

template <int KIND, typename TIn, int VEC, int MODE>
__global__ void __launch_bounds__(kThreads)
grouped_attention_kernel(const TIn* __restrict__ q, long long q_stride,
                         typename Elem<KIND>::T* pool,
                         const int* __restrict__ lengths,
                         const int* __restrict__ table,
                         const float* __restrict__ k_scales,
                         const float* __restrict__ v_scales,
                         const TIn* __restrict__ k_new, long long kn_stride,
                         const TIn* __restrict__ v_new, long long vn_stride,
                         float* __restrict__ out,
                         const int* __restrict__ ring_start,
                         float* __restrict__ m_out, float* __restrict__ l_out,
                         int D, int NP, int P, int W, int H, float sm_scale) {
  using E = typename Elem<KIND>::T;
  constexpr bool FUSED = MODE == kFused;
  constexpr bool RING = MODE == kRing;
  constexpr bool kQuant = KIND != kF32;
  constexpr bool kPacked = KIND == kI4;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Dk = kPacked ? D / 2 : D;
  const int dh = D / H;
  const int dhk = Dk / H;  // storage elements per head
  const int Lcap = W * P;
  // positions the block attends over: [0, L)
  const int live_len = min(max(lengths[b], 0), Lcap);
  const int L = RING ? (live_len > 0 ? min(max(ring_start[b], 0), Lcap) : 0)
                     : live_len;
  float* o = out + static_cast<long long>(b) * D;
  if (L == 0) {
    for (int c = tid; c < D; c += kThreads) o[c] = 0.0f;
    if constexpr (RING) {
      for (int h = tid; h < H; h += kThreads) {
        m_out[static_cast<long long>(b) * H + h] = -CUDART_INF_F;
        l_out[static_cast<long long>(b) * H + h] = 0.0f;
      }
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay(D, Dk, H, Lcap, sizeof(E));
  E* new_k = reinterpret_cast<E*>(smem + lay.new_rows);
  E* new_v = new_k + Dk;
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* sc = reinterpret_cast<float*>(smem + lay.scores);
  long long* tok_off = reinterpret_cast<long long*>(smem + lay.tok_off);
  int* tok_page = reinterpret_cast<int*>(smem + lay.tok_page);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* red = reinterpret_cast<float*>(smem + lay.red);

  // ---- fused insert of the new row at position L-1 ----
  if constexpr (FUSED) {
    const int pos = L - 1;
    const int pid = table[static_cast<long long>(b) * W + pos / P];
    const bool write = pid >= 0 && pid < NP;
    const int spid = min(max(pid, 0), NP - 1);
    for (int side = 0; side < 2; ++side) {
      const TIn* src = side ? v_new + b * vn_stride : k_new + b * kn_stride;
      float inv = 0.0f;
      if constexpr (kQuant) {
        const float s = (side ? v_scales : k_scales)[spid];
        inv = s > 0.0f ? 1.0f / fmaxf(s, 1e-30f) : 0.0f;
      }
      E* dst = pool + ((static_cast<long long>(spid) * 2 + side) * P + pos % P) * Dk;
      E* sh = side ? new_v : new_k;
      for (int e = tid; e < Dk; e += kThreads) {
        E val;
        if constexpr (KIND == kF32) {
          val = to_f32(src[e]);
        } else if constexpr (KIND == kI8) {
          val = static_cast<int8_t>(quant(to_f32(src[e]), inv, 127.0f));
        } else {
          const int h = e / dhk, j = e - h * dhk;
          const float lo = quant(to_f32(src[h * dh + j]), inv, 7.0f);
          const float hi = quant(to_f32(src[h * dh + dhk + j]), inv, 7.0f);
          val = static_cast<int8_t>(static_cast<int>(16.0f * hi + lo));
        }
        sh[e] = val;
        if (write) dst[e] = val;
      }
    }
  }

  for (int c = tid; c < D; c += kThreads) q_s[c] = to_f32(q[b * q_stride + c]);
  for (int t = tid; t < L; t += kThreads) {
    const int page = min(max(table[static_cast<long long>(b) * W + t / P], 0), NP - 1);
    tok_page[t] = page;
    tok_off[t] = (static_cast<long long>(page) * 2 * P + t % P) * Dk;
  }
  __syncthreads();

  // ---- pass 1: scores, one warp per token ----
  for (int t = warp; t < L; t += kWarps) {
    const E* krow = (FUSED && t == L - 1) ? new_k : pool + tok_off[t];
    const float ks = kQuant ? k_scales[tok_page[t]] : 1.0f;
    for (int h = 0; h < H; ++h) {
      const E* kh = krow + h * dhk;
      const float* qh = q_s + h * dh;
      float acc = 0.0f;
      for (int j = lane * VEC; j < dhk; j += 32 * VEC) {
        float lo[VEC], hi[VEC];
        load_vals<KIND, VEC>(kh + j, lo, hi);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          acc += qh[j + i] * lo[i];
          if constexpr (kPacked) acc += qh[dhk + j + i] * hi[i];
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) sc[h * Lcap + t] = acc * ks * sm_scale;
    }
  }
  __syncthreads();

  // ---- softmax per head; V page scales folded into the weights ----
  for (int h = 0; h < H; ++h) {
    float* s = sc + h * Lcap;
    float m = -CUDART_INF_F;
    for (int t = tid; t < L; t += kThreads) m = fmaxf(m, s[t]);
    m = block_reduce<true>(m, red);
    float l = 0.0f;
    for (int t = tid; t < L; t += kThreads) {
      const float p = expf(s[t] - m);
      l += p;
      s[t] = kQuant ? p * v_scales[tok_page[t]] : p;
    }
    l = block_reduce<false>(l, red);
    if (tid == 0) {
      l_s[h] = l;
      if constexpr (RING) {
        m_out[static_cast<long long>(b) * H + h] = m;
        l_out[static_cast<long long>(b) * H + h] = l;
      }
    }
  }
  __syncthreads();

  // ---- pass 2: o = sum_t w_t V_t / l, each thread VEC storage elements ----
  for (int e0 = tid * VEC; e0 < Dk; e0 += kThreads * VEC) {
    const int h = e0 / dhk, j0 = e0 - h * dhk;
    const float* w = sc + h * Lcap;
    float acc_lo[VEC], acc_hi[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc_lo[i] = acc_hi[i] = 0.0f;
#pragma unroll 4
    for (int t = 0; t < L; ++t) {
      const E* vrow = (FUSED && t == L - 1) ? new_v : pool + tok_off[t] + size_t(P) * Dk;
      float lo[VEC], hi[VEC];
      load_vals<KIND, VEC>(vrow + e0, lo, hi);
      const float p = w[t];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        acc_lo[i] += p * lo[i];
        if constexpr (kPacked) acc_hi[i] += p * hi[i];
      }
    }
    const float l = l_s[h];
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

template <int KIND, typename TIn, int VEC, int MODE>
cudaError_t launch(const void* q, long long q_stride, void* pool,
                   const int* lengths, const int* table, const float* k_scales,
                   const float* v_scales, const void* k_new, long long kn_stride,
                   const void* v_new, long long vn_stride, float* out,
                   const int* ring_start, float* m_out, float* l_out, int B,
                   int D, int NP, int P, int W, int H, float sm_scale,
                   cudaStream_t stream) {
  using E = typename Elem<KIND>::T;
  const int Dk = KIND == kI4 ? D / 2 : D;
  const Smem lay(D, Dk, H, W * P, sizeof(E));
  auto kernel = grouped_attention_kernel<KIND, TIn, VEC, MODE>;
  if (lay.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(lay.total));
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, kThreads, lay.total, stream>>>(
      static_cast<const TIn*>(q), q_stride, static_cast<E*>(pool), lengths,
      table, k_scales, v_scales, static_cast<const TIn*>(k_new), kn_stride,
      static_cast<const TIn*>(v_new), vn_stride, out, ring_start, m_out, l_out,
      D, NP, P, W, H, sm_scale);
  return cudaGetLastError();
}

template <int KIND, typename TIn>
cudaError_t dispatch_vec(int vec, int mode, const void* q, long long q_stride,
                         void* pool, const int* lengths, const int* table,
                         const float* k_scales, const float* v_scales,
                         const void* k_new, long long kn_stride,
                         const void* v_new, long long vn_stride, float* out,
                         const int* ring_start, float* m_out, float* l_out,
                         int B, int D, int NP, int P, int W, int H,
                         float sm_scale, cudaStream_t stream) {
#define MLI_LAUNCH(V, M)                                                     \
  return launch<KIND, TIn, V, M>(q, q_stride, pool, lengths, table, k_scales, \
                                 v_scales, k_new, kn_stride, v_new,          \
                                 vn_stride, out, ring_start, m_out, l_out,   \
                                 B, D, NP, P, W, H, sm_scale, stream)
  if (vec == 4) {
    if (mode == kFused) MLI_LAUNCH(4, kFused);
    if (mode == kRing) MLI_LAUNCH(4, kRing);
    MLI_LAUNCH(4, kPlain);
  }
  if (mode == kFused) MLI_LAUNCH(1, kFused);
  if (mode == kRing) MLI_LAUNCH(1, kRing);
  MLI_LAUNCH(1, kPlain);
#undef MLI_LAUNCH
}

}  // namespace

extern "C" {

// The launcher of the kernel above. pool_kind: 0 float32, 1 int8, 2 packed
// int4 (int8 storage, Dk = D/2). q/k_new/v_new are float32 (in_bf16 = 0) or
// bfloat16 (in_bf16 = 1) rows with the given row strides (elements) and
// unit inner stride; k_new == NULL selects mode (a) (no insert), and
// ring_start != NULL mode (c), which also writes m_out/l_out [B, H] (k_new
// must then be NULL). vec is 4 when every head's row segment is 4-element
// aligned, else 1. Returns the cudaError_t of the launch (0 = launched).
int mli_grouped_attention(const void* q, long long q_stride, void* pool,
                          const int* lengths, const int* table,
                          const float* k_scales, const float* v_scales,
                          const void* k_new, long long kn_stride,
                          const void* v_new, long long vn_stride, float* out,
                          const int* ring_start, float* m_out, float* l_out,
                          int B, int D, int NP, int P, int W, int H,
                          int pool_kind, int in_bf16, int vec, float sm_scale,
                          void* stream) {
  if (B <= 0) return 0;
  if (H <= 0 || D % H != 0 || (vec != 1 && vec != 4)) return cudaErrorInvalidValue;
  if (ring_start != nullptr &&
      (k_new != nullptr || m_out == nullptr || l_out == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mode = ring_start != nullptr ? kRing
                   : k_new != nullptr    ? kFused
                                         : kPlain;
#define MLI_DISPATCH(KIND)                                                   \
  return in_bf16                                                             \
      ? dispatch_vec<KIND, __nv_bfloat16>(vec, mode, q, q_stride, pool,     \
            lengths, table, k_scales, v_scales, k_new, kn_stride, v_new,    \
            vn_stride, out, ring_start, m_out, l_out, B, D, NP, P, W, H,    \
            sm_scale, s)                                                    \
      : dispatch_vec<KIND, float>(vec, mode, q, q_stride, pool, lengths,    \
            table, k_scales, v_scales, k_new, kn_stride, v_new, vn_stride,  \
            out, ring_start, m_out, l_out, B, D, NP, P, W, H, sm_scale, s)
  switch (pool_kind) {
    case kF32: MLI_DISPATCH(kF32);
    case kI8: MLI_DISPATCH(kI8);
    case kI4: MLI_DISPATCH(kI4);
    default: return cudaErrorInvalidValue;
  }
#undef MLI_DISPATCH
}

// Shared memory bytes a launch of mli_grouped_attention needs.
long long mli_grouped_attention_smem(int D, int H, int W, int P, int pool_kind) {
  const int Dk = pool_kind == kI4 ? D / 2 : D;
  return static_cast<long long>(
      Smem(D, Dk, H, W * P, pool_kind == kF32 ? 4 : 1).total);
}

const char* mli_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
