// Causal prefill attention over a prompt block for Hopper (sm_90a),
// flash-style: scores and probabilities stay on chip.
//
// Replaces no TPU kernel: the JAX package's prefill attention is plain XLA
// (min_llm_inference_tpu/models/model.py :: causal_masked_attention). It
// was added because the port's plain version of that function (models/
// model.py :: causal_masked_attention, ops/reference.py :: masked_softmax)
// holds float32 scores of [M, H, S, S] in device memory and runs some eight
// elementwise passes over them: at a gpt2-small prefill block (64 prompts
// of 512-896 tokens padded to S = 1024, 12 heads of 64) that is 3.2 GB a
// pass, ~20-25 ms a layer, where the work itself is ~0.1 ms.
//
// Contract. q, k: [M, S, H * DK], v: [M, S, H * DV] bfloat16 with row
// strides (s0 over M, s1 over S; unit inner stride: k and v may be column
// slices of one fused projection); lengths: [M] int32 on the device, at
// any element stride (a column of a larger block does). DK = DV = 16, 32,
// ..., 128 (multi-head attention), or DK = 192 and DV = 128 (latent
// attention's prefill: k_nope and the shared roped k_pe a head). For every
// prompt m, head h and row i < lengths[m]:
//   out[m, i, h*DV + d] = sum_j p_j v[m, j, h*DV + d],
//   p = softmax_j(scale * q_i . k_j) over j <= i and j < lengths[m];
// rows lengths[m] <= i < S are written as zeros. out is float32 or
// bfloat16 (rounded to nearest once, at the end).
//
// Precision. q . k runs on the tensor cores in bf16 with float32
// accumulation: bf16 x bf16 products are exact in float32, so only the
// order of the sum differs from the plain float32 product. The scale is
// one float32 multiply (as the plain path's). Softmax statistics are
// float32 with IEEE expf (built without fast math). P is never rounded
// below float32: each p is split into three bf16 terms whose sum is p
// exactly (three 8-bit slices of its 24-bit significand), and each term
// goes through its own mma against the bf16 V, products exact in float32.
//
// Bound on this card. Bytes: q, k, v read once and the output written once
// (~0.4 GB at the cell's shapes, ~0.1 ms at 3.35 TB/s). The tensor-core
// work (q . k once, P . V three times over the causal pairs) is ~0.1 ms
// at 989 TFLOP/s. What the design does about it:
//   * grid: one block of 4 warps per (query tile of 64 rows, head,
//     prompt), the tiles with the most keys first, so the grid's tail is
//     short; a tile whose first row is at or past the prompt's length
//     writes zeros and returns (unused rows of a block have length 0);
//   * key loop over tiles of 64 keys, only those that some valid (row,
//     key) pair needs: j * 64 <= min(last row of the tile, length - 1);
//     each warp also skips the 8-key column groups past its own last row
//     or the length;
//   * K and V tiles double-buffered in shared memory by cp.async (rows
//     at or past the length zero-filled, so that no garbage reaches an
//     mma), fragments read by ldmatrix from rows padded by 16 bytes
//     (conflict-free);
//   * scores, running max and sum in registers (online softmax): nothing
//     of [S, S] ever leaves the SM; the output is divided by the row sum
//     once and stored straight into [M, S, D] at the head's columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kBlockM = 64;           // query rows a block
constexpr int kBlockN = 64;           // keys a tile
constexpr int kWarps = kBlockM / 16;  // 16 query rows a warp
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;               // bf16 padding a shared-memory row
constexpr int kMaxDevices = 64;

// A tile of 64 rows of width D in shared memory
template <int D>
struct Tile {
  static constexpr int kRow = D + kPad;           // elements a smem row
  static constexpr int kElems = kBlockM * kRow;   // one tile (kBlockN rows)
  static constexpr int kChunks = D / 8;           // 16-byte chunks a row
};

// Q, K x 2 (DK wide), V x 2 (DV wide)
template <int DK, int DV>
constexpr int smem_bytes() {
  return (3 * Tile<DK>::kElems + 2 * Tile<DV>::kElems) * 2;
}
static_assert(kBlockM == kBlockN, "one tile shape for Q, K and V");

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  void* out;
  long long q_s0, q_s1, k_s0, k_s1, v_s0, v_s1, o_s0, o_s1;
  const int* lengths;
  long long len_s0;
  int M, S, H, n_qtiles;
  float scale;
  int out_f32;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16 x 16 bf16, row-major) . b (16 x 8 bf16, column-major), float32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16x2 (x in the low half), each rounded to nearest: one
// cvt.rn.bf16x2.f32
__device__ __forceinline__ uint32_t bf16x2(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float low_f32(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float high_f32(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// Row r of the A fragments (hi, mid, lo) of P: (x, y) = hi + mid + lo
// exactly. Each term rounds the remainder to nearest; the remainders are
// exact in float32, and the last one fits bf16's 8-bit significand (three
// 8-bit slices of a 24-bit significand).
__device__ __forceinline__ void split_pair(float x, float y,
                                           uint32_t (&a)[3][4], int r) {
  uint32_t t = bf16x2(x, y);
  a[0][r] = t;
  x -= low_f32(t);
  y -= high_f32(t);
  t = bf16x2(x, y);
  a[1][r] = t;
  a[2][r] = bf16x2(x - low_f32(t), y - high_f32(t));
}

// The A fragments of P for keys 16 kt .. 16 kt + 15: the accumulator
// layout of two 8-key score tiles is the A layout of m16n8k16.
__device__ __forceinline__ void p_fragments(const float (&s0)[4],
                                            const float (&s1)[4],
                                            uint32_t (&a)[3][4]) {
  split_pair(s0[0], s0[1], a, 0);
  split_pair(s0[2], s0[3], a, 1);
  split_pair(s1[0], s1[1], a, 2);
  split_pair(s1[2], s1[3], a, 3);
}

// Rows [r_begin, r_end) of head h of prompt m written as zeros, 16 bytes a
// store.
template <int DV>
__device__ __forceinline__ void zero_rows(const Args& a, int m, int h, int r_begin,
                          int r_end) {
  const int esize = a.out_f32 ? 4 : 2;
  const int per_row = DV * esize / 16;
  char* base = static_cast<char*>(a.out) +
               (static_cast<long long>(m) * a.o_s0 + h * DV) * esize;
  for (int idx = threadIdx.x; idx < (r_end - r_begin) * per_row;
       idx += kThreads) {
    const int r = r_begin + idx / per_row, c = idx % per_row;
    *reinterpret_cast<uint4*>(base + r * a.o_s1 * esize + c * 16) =
        make_uint4(0, 0, 0, 0);
  }
}

// Rows row0 .. row0 + 63 of one head of one prompt, D wide (rows at or
// past `limit` zero-filled), into a padded shared-memory tile.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          long long s1, int row0, int limit) {
  using T = Tile<D>;
#pragma unroll
  for (int i = 0; i < kBlockM * T::kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / T::kChunks, c = idx % T::kChunks;
    const int gr = row0 + r;
    const bool ok = gr < limit;
    const __nv_bfloat16* src = ok ? base + gr * s1 + c * 8 : base;
    cp_async16(smem_u32(dst + r * T::kRow + c * 8), src, ok ? 16 : 0);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
    causal_prefill_kernel(const Args a) {
  using TK = Tile<DK>;
  using TV = Tile<DV>;
  static_assert(DK % 16 == 0 && DV % 16 == 0 && DK <= 192 && DV <= 128,
                "head widths multiples of 16");
  static_assert(kBlockM * TK::kChunks % kThreads == 0 &&
                kBlockM * TV::kChunks % kThreads == 0, "whole load steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + TK::kElems;      // two buffers
  __nv_bfloat16* sV = sK + 2 * TK::kElems;  // two buffers

  // the last query tiles (the most keys) first
  const int mh = a.M * a.H;
  const int qt = a.n_qtiles - 1 - static_cast<int>(blockIdx.x) / mh;
  const int rest = static_cast<int>(blockIdx.x) % mh;
  const int m = rest / a.H, h = rest - m * a.H;
  const int len = min(max(a.lengths[m * a.len_s0], 0), a.S);
  const int r0 = qt * kBlockM;
  if (r0 >= len) {
    zero_rows<DV>(a, m, h, r0, min(r0 + kBlockM, a.S));
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the last key any valid row of the tile attends to
  const int last = min(r0 + kBlockM, len) - 1;
  const int n_k = last / kBlockN + 1;
  const __nv_bfloat16* qb = a.q + m * a.q_s0 + h * DK;
  const __nv_bfloat16* kb = a.k + m * a.k_s0 + h * DK;
  const __nv_bfloat16* vb = a.v + m * a.v_s0 + h * DV;

  load_tile<DK>(sQ, qb, a.q_s1, r0, len);
  load_tile<DK>(sK, kb, a.k_s1, 0, len);
  load_tile<DV>(sV, vb, a.v_s1, 0, len);
  cp_async_commit();

  const int wrow = warp * 16;
  const int warp_last = r0 + wrow + 15;
  const int row_a = r0 + wrow + (lane >> 2);  // this thread's rows: +0, +8
  uint32_t qf[DK / 16][4];
  float o[DV / 8][4];
#pragma unroll
  for (int d = 0; d < DV / 8; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};

  for (int j = 0; j < n_k; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_k) {
      load_tile<DK>(sK + (buf ^ 1) * TK::kElems, kb, a.k_s1, (j + 1) * kBlockN,
                    len);
      load_tile<DV>(sV + (buf ^ 1) * TV::kElems, vb, a.v_s1, (j + 1) * kBlockN,
                    len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        ldmatrix_x4(qf[kk], smem_u32(sQ + (wrow + (lane & 15)) * TK::kRow +
                                     kk * 16 + (lane >> 4) * 8));
    }
    const __nv_bfloat16* tK = sK + buf * TK::kElems;
    const __nv_bfloat16* tV = sV + buf * TV::kElems;
    const int key0 = j * kBlockN;
    // the 8-key groups of this tile that hold a key this warp's rows may
    // see (at most its last row, below the length); the rest are masked
    const int groups = (min(warp_last, len - 1) - key0) / 8;  // last index
    const bool masked = key0 + kBlockN - 1 > r0 + wrow || key0 + kBlockN > len;

    // ---- scores: s = q . k over the tile's keys ----
    float s[kBlockN / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < kBlockN / 16; ++n2) {
        if (2 * n2 <= groups) {
          uint32_t b[4];
          ldmatrix_x4(b, smem_u32(tK + (n2 * 16 + (lane & 7) +
                                        ((lane >> 4) << 3)) * TK::kRow +
                                  kk * 16 + ((lane >> 3) & 1) * 8));
          mma(s[2 * n2], qf[kk], b[0], b[1]);
          mma(s[2 * n2 + 1], qf[kk], b[2], b[3]);
        }
      }
    }

    // ---- online softmax, float32 ----
    float mx[2] = {row_max[0], row_max[1]};
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_a + (e >> 1) * 8;
        const int key = key0 + n * 8 + (lane & 3) * 2 + (e & 1);
        float x = __fmul_rn(s[n][e], a.scale);
        if (masked && (key > row || key >= len)) x = -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // a row with no valid key yet keeps p = 0 and no NaN
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];
      const float alpha = expf(row_max[i] - base[i]);
      row_max[i] = mx[i];
      row_sum[i] *= alpha;
#pragma unroll
      for (int d = 0; d < DV / 8; ++d) {
        o[d][2 * i] *= alpha;
        o[d][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - base[e >> 1]);
        s[n][e] = p;
        row_sum[e >> 1] += p;
      }
    }

    // ---- o += P . V, P in three exact bf16 terms ----
#pragma unroll
    for (int kt = 0; kt < kBlockN / 16; ++kt) {
      if (2 * kt <= groups) {
        uint32_t pa[3][4];
        p_fragments(s[2 * kt], s[2 * kt + 1], pa);
#pragma unroll
        for (int d2 = 0; d2 < DV / 16; ++d2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, smem_u32(tV + (kt * 16 + (lane & 15)) * TV::kRow +
                                        d2 * 16 + (lane >> 4) * 8));
#pragma unroll
          for (int t = 2; t >= 0; --t) {  // the smallest terms first
            mma(o[2 * d2], pa[t], b[0], b[1]);
            mma(o[2 * d2 + 1], pa[t], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }

  // ---- out = o / row sum; rows at or past the length are zeros ----
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 1);
    row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + i * 8;
    if (row >= a.S) continue;
    const bool valid = row < len;
    const long long off = static_cast<long long>(m) * a.o_s0 + row * a.o_s1 +
                          h * DV + (lane & 3) * 2;
#pragma unroll
    for (int d = 0; d < DV / 8; ++d) {
      const float x0 = valid ? o[d][2 * i] / row_sum[i] : 0.f;
      const float x1 = valid ? o[d][2 * i + 1] / row_sum[i] : 0.f;
      if (a.out_f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + off + d * 8) =
            make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(a.out) + off + d * 8) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// Launches above 48 KB of shared memory need the kernel's attribute raised,
// once per device.
template <int DK, int DV>
cudaError_t launch(const Args& a, long long blocks, cudaStream_t stream) {
  auto kernel = causal_prefill_kernel<DK, DV>;
  constexpr int smem = smem_bytes<DK, DV>();
  if constexpr (smem > 48 * 1024) {
    static std::mutex mu;
    static bool raised[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mu);
    if (dev >= kMaxDevices || !raised[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      if (dev < kMaxDevices) raised[dev] = true;
    }
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launcher of the kernel above. q, k, v: bfloat16, strides in elements
// (s0 over M, s1 over S), every base 16-byte aligned and every stride a
// multiple of 8; out: float32 (out_f32 = 1) or bfloat16 (0), the same rules
// at its element size; lengths: [M] int32 on the device, len_s0 elements
// apart. (head_dim, v_dim) is (d, d) for d one of 16, 32, ..., 128, or
// (192, 128). Allocates nothing and never synchronises. Returns the
// cudaError_t of the launch (0 = launched).
int mli_prefill_attention(const void* q, const void* k, const void* v,
                          void* out, long long q_s0, long long q_s1,
                          long long k_s0, long long k_s1, long long v_s0,
                          long long v_s1, long long o_s0, long long o_s1,
                          const int* lengths, long long len_s0, int M,
                          int S, int H, int head_dim, int v_dim, float scale,
                          int out_f32, void* stream) {
  if (M <= 0 || S <= 0 || H <= 0) return 0;
  Args a{static_cast<const __nv_bfloat16*>(q),
         static_cast<const __nv_bfloat16*>(k),
         static_cast<const __nv_bfloat16*>(v),
         out, q_s0, q_s1, k_s0, k_s1, v_s0, v_s1, o_s0, o_s1, lengths,
         len_s0, M, S, H, (S + kBlockM - 1) / kBlockM, scale,
         out_f32 ? 1 : 0};
  const long long blocks = static_cast<long long>(a.n_qtiles) * M * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 192 && v_dim == 128) return launch<192, 128>(a, blocks, s);
  if (v_dim != head_dim) return cudaErrorInvalidValue;
  switch (head_dim) {
    case 16: return launch<16, 16>(a, blocks, s);
    case 32: return launch<32, 32>(a, blocks, s);
    case 48: return launch<48, 48>(a, blocks, s);
    case 64: return launch<64, 64>(a, blocks, s);
    case 80: return launch<80, 80>(a, blocks, s);
    case 96: return launch<96, 96>(a, blocks, s);
    case 112: return launch<112, 112>(a, blocks, s);
    case 128: return launch<128, 128>(a, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* mli_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
