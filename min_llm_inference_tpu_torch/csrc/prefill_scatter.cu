// Fused int8 prefill quantize + page scatter for Hopper (sm_90a), in place.
//
// Replaces the Pallas TPU kernel
//   min_llm_inference_tpu/ops/prefill_scatter.py :: prefill_quant_scatter
//   (kernel body _kernel)
//
// Contract. k, v: [M, W_pre * P, D] float32 or bfloat16 blocks (row strides
// given, unit inner stride: they may be column slices of one fused K|V
// projection); pid, inv_k, inv_v: [M, W_pre]. For every (m, w) with
// 0 <= pid < NP and each side, the kernel writes
//   pool[pid, side, r, d] = int8(clip(rint(x[m, w*P + r, d] * inv), -127, 127))
// for r < P, d < D; pid == NP (uncovered pages, padding rows) writes
// nothing. The inverse scales are computed beforehand from the updated page
// scales (inv = s > 0 ? 1 / max(s, 1e-30) : 0). The product is one float32
// multiply and rintf rounds half to even: built without fast math this is
// bit-identical to the plain quantize (ops/quant.quantize_against) and to
// the JAX kernel.
//
// Bound on this card: bytes, each covered page's K and V rows read once
// (2 or 4 bytes per value) and written once as int8. Grid (M * W_pre, 2):
// one block per page and side, a contiguous [P, D] int8 destination; each
// thread converts VEC values per step (16-byte loads) when rows are VEC
// aligned, else one value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ int8_t quant(float x, float inv) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(x * inv), -127.0f), 127.0f));
}

// VEC values of x at p (16-byte aligned when VEC > 1).
template <typename TIn, int VEC>
__device__ __forceinline__ void load_vec(const TIn* p, float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = to_f32(p[0]);
  } else {
    static_assert(VEC * sizeof(TIn) == 16, "16-byte vector loads");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const TIn* v = reinterpret_cast<const TIn*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = to_f32(v[i]);
  }
}

template <typename TIn, int VEC>
__global__ void __launch_bounds__(kThreads)
prefill_scatter_kernel(int8_t* __restrict__ pool,
                       const TIn* __restrict__ k, const TIn* __restrict__ v,
                       long long k_s0, long long k_s1, long long v_s0,
                       long long v_s1, const int* __restrict__ pid,
                       const float* __restrict__ inv_k,
                       const float* __restrict__ inv_v, int W_pre, int P,
                       int D, int NP) {
  const int mw = blockIdx.x;
  const int side = blockIdx.y;
  const int page = pid[mw];
  if (page < 0 || page >= NP) return;
  const int m = mw / W_pre, w = mw - m * W_pre;
  const float inv = (side ? inv_v : inv_k)[mw];
  const long long s0 = side ? v_s0 : k_s0, s1 = side ? v_s1 : k_s1;
  const TIn* src = (side ? v : k) + m * s0 + static_cast<long long>(w) * P * s1;
  int8_t* dst = pool + (static_cast<long long>(page) * 2 + side) * P * D;
  const int per_row = D / VEC;
  for (int idx = threadIdx.x; idx < P * per_row; idx += kThreads) {
    const int r = idx / per_row;
    const int d = (idx - r * per_row) * VEC;
    float x[VEC];
    load_vec<TIn, VEC>(src + r * s1 + d, x);
    int8_t* out = dst + static_cast<long long>(r) * D + d;
    if constexpr (VEC == 1) {
      out[0] = quant(x[0], inv);
    } else if constexpr (VEC == 4) {
      char4 q4;
      q4.x = quant(x[0], inv); q4.y = quant(x[1], inv);
      q4.z = quant(x[2], inv); q4.w = quant(x[3], inv);
      *reinterpret_cast<char4*>(out) = q4;
    } else {
      uint2 packed;
      int8_t* b = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
      for (int i = 0; i < VEC; ++i) b[i] = quant(x[i], inv);
      *reinterpret_cast<uint2*>(out) = packed;
    }
  }
}

template <typename TIn, int VEC>
cudaError_t launch(void* pool, const void* k, const void* v, long long k_s0,
                   long long k_s1, long long v_s0, long long v_s1,
                   const int* pid, const float* inv_k, const float* inv_v,
                   int M, int W_pre, int P, int D, int NP,
                   cudaStream_t stream) {
  const dim3 grid(M * W_pre, 2);
  prefill_scatter_kernel<TIn, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<int8_t*>(pool), static_cast<const TIn*>(k),
      static_cast<const TIn*>(v), k_s0, k_s1, v_s0, v_s1, pid, inv_k, inv_v,
      W_pre, P, D, NP);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launcher of the kernel above. k/v are float32 (in_bf16 = 0) or
// bfloat16 (in_bf16 = 1) with strides (elements) s0 over M and s1 over the
// block's rows. vec = 1 selects one value per step; vec = 0 selects
// 16-byte loads (8 bf16 or 4 float32), valid when D and both row strides
// are multiples of that count and both bases are 16-byte aligned. Returns
// the cudaError_t of the launch (0 = launched).
int mli_prefill_quant_scatter(void* pool, const void* k, const void* v,
                              long long k_s0, long long k_s1, long long v_s0,
                              long long v_s1, const int* pid,
                              const float* inv_k, const float* inv_v, int M,
                              int W_pre, int P, int D, int NP, int in_bf16,
                              int vec, void* stream) {
  if (M <= 0 || W_pre <= 0) return 0;
  if (P <= 0 || D <= 0 || (vec != 0 && vec != 1)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return vec == 1
        ? launch<__nv_bfloat16, 1>(pool, k, v, k_s0, k_s1, v_s0, v_s1, pid,
                                   inv_k, inv_v, M, W_pre, P, D, NP, s)
        : launch<__nv_bfloat16, 8>(pool, k, v, k_s0, k_s1, v_s0, v_s1, pid,
                                   inv_k, inv_v, M, W_pre, P, D, NP, s);
  }
  return vec == 1
      ? launch<float, 1>(pool, k, v, k_s0, k_s1, v_s0, v_s1, pid, inv_k,
                         inv_v, M, W_pre, P, D, NP, s)
      : launch<float, 4>(pool, k, v, k_s0, k_s1, v_s0, v_s1, pid, inv_k,
                         inv_v, M, W_pre, P, D, NP, s);
}

const char* mli_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
