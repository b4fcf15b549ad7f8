// Absorbed multi-head latent attention over a paged latent pool, one decode
// round, for Hopper (sm_90a): DeepSeek-V2's decode attention.
//
// Replaces no TPU kernel: the JAX package has no latent attention. It was
// added because no kernel of the port computes this: 16 query heads read
// one shared 576-wide latent row a token (c_kv, 512, then the roped k_pe,
// 64), where the port's other attention kernels read K and V planes per
// head.
//
// Contract. q: [B, 16, 576] bfloat16, contiguous: each head's absorbed
// query (q_nope . W_UK, 512, then its roped q_pe, 64). pool: [NP, P, 576]
// bfloat16 (P a power of two). page_table: [B, W] int32 (row stride
// pt_s0); lengths: [B] int32, 0 = a dead slot. For every live slot b and
// head h:
//   out[b, h, :] = sum_t p_t pool_row(b, t)[0:512],
//   p = softmax_t(scale * q[b, h] . pool_row(b, t)) over t < lengths[b];
// a dead slot's rows are zeros. out is bfloat16 [B, 16, 512].
//
// Precision. q . row runs on the tensor cores in bf16 with float32
// accumulation (bf16 products are exact in float32). The scale is one
// float32 multiply of the summed score; softmax statistics are float32
// with IEEE expf. P never drops below ~17 bits: each p is split into two
// bf16 terms (hi = p rounded, lo = p - hi rounded) and each term goes
// through its own mma against the bf16 row. Split partials combine in
// float32; the output rounds to bf16 once.
//
// Bound on this card. Each live token's row is read once: 1,152 bytes for
// 16 x (576 + 512) x 2 = 34,816 FLOPs, 30 FLOP/B. At 3.35 TB/s that is
// ~101 TFLOP/s, above the 67 TFLOP/s of the float32 CUDA cores, so the
// products go to the tensor cores (mma.sync m16n8k16), which leaves HBM
// the bound. What the design does about it:
//   * grid: (slot, split) blocks; a split is a run of whole pages of one
//     slot's context, so that 256 slots fill 132 SMs several times over;
//     a split past the slot's length writes an empty partial and returns;
//   * one block of 4 warps holds the 16 heads as the 16 rows of one mma
//     tile: a latent row is read from HBM once for all heads;
//   * tiles of 32 tokens double-buffered in shared memory by cp.async
//     (rows past the split's end zero-filled), rows padded by 16 bytes so
//     that ldmatrix is conflict-free; ~102 KB a block, two blocks an SM;
//   * scores: each warp takes a quarter of the 576-wide dot (9 k-steps of
//     16, its q fragments kept in registers) for all 32 tokens; the four
//     partial score tiles meet in shared memory, where the online softmax
//     (running max and sum per head, float32) turns them into P;
//   * P . V: each warp owns 128 of the 512 output columns (float32
//     accumulators in registers), V being the first 512 of the tile's rows
//     read by ldmatrix.trans from the same shared-memory tile;
//   * a second kernel combines the splits' (o, max, sum) in float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kHeads = 16;
constexpr int kLatent = 512;                   // c_kv, the value width
constexpr int kRow = 576;                      // c_kv + k_pe
constexpr int kTile = 32;                      // tokens a tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;                        // bf16 padding a smem row
constexpr int kSRow = kRow + kPad;             // elements a smem row
constexpr int kChunks = kRow / 8;              // 16-byte chunks a row
constexpr int kKSteps = kRow / 16;             // k-steps of one dot
constexpr int kKPerWarp = kKSteps / kWarps;    // 9
constexpr int kVCols = kLatent / kWarps;       // 128 output columns a warp
constexpr int kPRow = kTile + 8;               // bf16 a P row
constexpr int kStages = 2;
constexpr int kMaxDevices = 64;
static_assert(kKSteps % kWarps == 0, "whole k-steps a warp");
static_assert(kTile * kChunks % kThreads == 0, "whole load steps");
static_assert(kHeads * kTile == kThreads * 4, "four scores a thread");

constexpr int kSmemQ = kHeads * kSRow * 2;
constexpr int kSmemK = kStages * kTile * kSRow * 2;
constexpr int kSmemS = kWarps * kHeads * kTile * 4;
constexpr int kSmemP = 2 * kHeads * kPRow * 2;
constexpr int kSmem = kSmemQ + kSmemK + kSmemS + kSmemP + kHeads * 4;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* pool;
  const int* page_table;
  const int* lengths;
  float* o_part;  // [B, nsplit, 16, 512]
  float* ml;      // [B, nsplit, 16, 2]: running max, sum
  __nv_bfloat16* out;
  long long pt_s0;
  int B, W, log2P, n_pages, nsplit, split_tokens;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// Tokens [t_begin, t_begin + 32) of slot b's context (those at or past
// t_end zero-filled) into a padded shared-memory tile.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const Args& a,
                                          const int* pt, int t_begin,
                                          int t_end) {
  const int page_mask = (1 << a.log2P) - 1;
#pragma unroll 6
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx - r * kChunks;
    const int t = t_begin + r;
    const bool ok = t < t_end;
    const __nv_bfloat16* src = a.pool;
    if (ok) {
      const int page = min(max(pt[t >> a.log2P], 0), a.n_pages - 1);
      src = a.pool + ((static_cast<long long>(page) << a.log2P) +
                      (t & page_mask)) * kRow + c * 8;
    }
    cp_async16(smem_u32(dst + r * kSRow + c * 8), src, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    mla_partial_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw + kSmemQ);
  float* sS = reinterpret_cast<float*>(smem_raw + kSmemQ + kSmemK);
  __nv_bfloat16* sP =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + kSmemQ + kSmemK + kSmemS);
  float* sAlpha =
      reinterpret_cast<float*>(smem_raw + kSmemQ + kSmemK + kSmemS + kSmemP);

  const int b = static_cast<int>(blockIdx.x) / a.nsplit;
  const int split = static_cast<int>(blockIdx.x) - b * a.nsplit;
  const int len = a.lengths[b];
  const int t0 = split * a.split_tokens;
  const int t1 = min(t0 + a.split_tokens, len);
  float* ml = a.ml + (static_cast<long long>(b) * a.nsplit + split) * kHeads * 2;
  if (t0 >= t1) {
    if (threadIdx.x < kHeads) {
      ml[2 * threadIdx.x] = -INFINITY;
      ml[2 * threadIdx.x + 1] = 0.f;
    }
    return;
  }
  const int n_tiles = (t1 - t0 + kTile - 1) / kTile;
  const int* pt = a.page_table + b * a.pt_s0;
  const __nv_bfloat16* qb = a.q + static_cast<long long>(b) * kHeads * kRow;
  for (int idx = threadIdx.x; idx < kHeads * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx - r * kChunks;
    cp_async16(smem_u32(sQ + r * kSRow + c * 8), qb + r * kRow + c * 8, 16);
  }
  load_tile(sK, a, pt, t0, t1);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the softmax step's share: head srow, scores scol .. scol + 3
  const int srow = threadIdx.x >> 3, scol = (threadIdx.x & 7) * 4;
  float m_run = -INFINITY, l_run = 0.f;
  uint32_t qf[kKPerWarp][4];
  float o[kVCols / 8][4];
#pragma unroll
  for (int d = 0; d < kVCols / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(sK + (buf ^ 1) * kTile * kSRow, a, pt, t0 + (j + 1) * kTile,
                t1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kKPerWarp; ++kk)
        ldmatrix_x4(qf[kk], smem_u32(sQ + (lane & 15) * kSRow +
                                     (warp * kKPerWarp + kk) * 16 +
                                     (lane >> 4) * 8));
    }
    const __nv_bfloat16* tK = sK + buf * kTile * kSRow;

    // ---- this warp's quarter of the scores of all 32 tokens ----
    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKPerWarp; ++kk) {
      const int k0 = (warp * kKPerWarp + kk) * 16;
#pragma unroll
      for (int n2 = 0; n2 < kTile / 16; ++n2) {
        uint32_t bb[4];
        ldmatrix_x4(bb, smem_u32(tK + (n2 * 16 + (lane & 7) +
                                       ((lane >> 4) << 3)) * kSRow +
                                 k0 + ((lane >> 3) & 1) * 8));
        mma(s[2 * n2], qf[kk], bb[0], bb[1]);
        mma(s[2 * n2 + 1], qf[kk], bb[2], bb[3]);
      }
    }
    float* myS = sS + warp * kHeads * kTile;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      const int col = n * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(myS + (lane >> 2) * kTile + col) =
          make_float2(s[n][0], s[n][1]);
      *reinterpret_cast<float2*>(myS + ((lane >> 2) + 8) * kTile + col) =
          make_float2(s[n][2], s[n][3]);
    }
    __syncthreads();

    // ---- online softmax of head srow, float32; P as hi + lo bf16 ----
    {
      float x[4];
      float tmax = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = scol + i;
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += sS[(w * kHeads + srow) * kTile + col];
        v = __fmul_rn(v, a.scale);
        if (t0 + j * kTile + col >= t1) v = -INFINITY;
        x[i] = v;
        tmax = fmaxf(tmax, v);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 4));
      // every tile holds at least one valid token: m_new is finite
      const float m_new = fmaxf(m_run, tmax);
      const float alpha = expf(m_run - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(x[i] - m_new);
        psum += p;
        const __nv_bfloat16 hi = __float2bfloat16_rn(p);
        const __nv_bfloat16 lo = __float2bfloat16_rn(p - __bfloat162float(hi));
        sP[srow * kPRow + scol + i] = hi;
        sP[(kHeads + srow) * kPRow + scol + i] = lo;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      psum += __shfl_xor_sync(0xffffffffu, psum, 4);
      l_run = l_run * alpha + psum;
      m_run = m_new;
      if ((threadIdx.x & 7) == 0) sAlpha[srow] = alpha;
    }
    __syncthreads();

    // ---- o = alpha o + P . V over this warp's 128 columns ----
    const float a0 = sAlpha[lane >> 2], a1 = sAlpha[(lane >> 2) + 8];
#pragma unroll
    for (int d = 0; d < kVCols / 8; ++d) {
      o[d][0] *= a0;
      o[d][1] *= a0;
      o[d][2] *= a1;
      o[d][3] *= a1;
    }
#pragma unroll
    for (int kt = 0; kt < kTile / 16; ++kt) {
      uint32_t pa[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
        ldmatrix_x4(pa[t], smem_u32(sP + (t * kHeads + (lane & 15)) * kPRow +
                                    kt * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int d2 = 0; d2 < kVCols / 16; ++d2) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, smem_u32(tK + (kt * 16 + (lane & 15)) * kSRow +
                                       warp * kVCols + d2 * 16 +
                                       (lane >> 4) * 8));
        mma(o[2 * d2], pa[1], bb[0], bb[1]);  // the small term first
        mma(o[2 * d2 + 1], pa[1], bb[2], bb[3]);
        mma(o[2 * d2], pa[0], bb[0], bb[1]);
        mma(o[2 * d2 + 1], pa[0], bb[2], bb[3]);
      }
    }
    __syncthreads();  // the tile's buffer, sS and sP are rewritten next
  }

  // ---- the split's partial: o (relative to m_run), m_run, l_run ----
  float* op = a.o_part +
              (static_cast<long long>(b) * a.nsplit + split) * kHeads * kLatent;
#pragma unroll
  for (int d = 0; d < kVCols / 8; ++d) {
    const int col = warp * kVCols + d * 8 + (lane & 3) * 2;
    *reinterpret_cast<float2*>(op + (lane >> 2) * kLatent + col) =
        make_float2(o[d][0], o[d][1]);
    *reinterpret_cast<float2*>(op + ((lane >> 2) + 8) * kLatent + col) =
        make_float2(o[d][2], o[d][3]);
  }
  if ((threadIdx.x & 7) == 0) {
    ml[2 * srow] = m_run;
    ml[2 * srow + 1] = l_run;
  }
}

// One block per (slot, head): the splits' partials weighted by
// exp(m_s - max) and divided by the summed weights, float32; a dead slot
// (or a head no split reached) writes zeros.
__global__ void __launch_bounds__(kThreads) mla_combine_kernel(const Args a) {
  const int b = static_cast<int>(blockIdx.x) / kHeads;
  const int h = static_cast<int>(blockIdx.x) - b * kHeads;
  const int len = a.lengths[b];
  const int n = len > 0 ? min((len + a.split_tokens - 1) / a.split_tokens,
                              a.nsplit)
                        : 0;
  const float* ml = a.ml + static_cast<long long>(b) * a.nsplit * kHeads * 2;
  float mx = -INFINITY;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, ml[(s * kHeads + h) * 2]);
  float total = 0.f;
  for (int s = 0; s < n; ++s)
    total += ml[(s * kHeads + h) * 2 + 1] * expf(ml[(s * kHeads + h) * 2] - mx);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int col = threadIdx.x * 4;
  for (int s = 0; s < n; ++s) {
    const float w = expf(ml[(s * kHeads + h) * 2] - mx);
    const float4 v = *reinterpret_cast<const float4*>(
        a.o_part + ((static_cast<long long>(b) * a.nsplit + s) * kHeads + h) *
                       kLatent + col);
    acc.x += w * v.x;
    acc.y += w * v.y;
    acc.z += w * v.z;
    acc.w += w * v.w;
  }
  const float inv = total > 0.f ? 1.f / total : 0.f;
  __nv_bfloat16* out =
      a.out + (static_cast<long long>(b) * kHeads + h) * kLatent + col;
  *reinterpret_cast<__nv_bfloat162*>(out) =
      __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
  *reinterpret_cast<__nv_bfloat162*>(out + 2) =
      __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
}
static_assert(kThreads * 4 == kLatent, "four columns a combining thread");

cudaError_t raise_smem() {
  static std::mutex mu;
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev >= kMaxDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(mla_partial_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The launcher of the two kernels above. q: [B, 16, 576] bfloat16,
// contiguous; pool: [n_pages, 1 << log2P, 576] bfloat16, contiguous;
// page_table: [B, W] int32, rows pt_s0 elements apart; lengths: [B] int32;
// o_part: float32 scratch of B * nsplit * 16 * 512; ml: float32 scratch of
// B * nsplit * 32; out: [B, 16, 512] bfloat16, contiguous. A split covers
// split_tokens positions (a multiple of 32). Allocates nothing and never
// synchronises. Returns the cudaError_t of the launches (0 = launched).
int mli_mla_decode(const void* q, const void* pool, const int* page_table,
                   long long pt_s0, const int* lengths, void* o_part,
                   void* ml, void* out, int B, int W, int log2P, int n_pages,
                   int nsplit, int split_tokens, float scale, void* stream) {
  if (B <= 0) return 0;
  if (nsplit <= 0 || split_tokens <= 0 || split_tokens % kTile) {
    return cudaErrorInvalidValue;
  }
  Args a{static_cast<const __nv_bfloat16*>(q),
         static_cast<const __nv_bfloat16*>(pool),
         page_table, lengths, static_cast<float*>(o_part),
         static_cast<float*>(ml), static_cast<__nv_bfloat16*>(out), pt_s0,
         B, W, log2P, n_pages, nsplit, split_tokens, scale};
  cudaError_t err = raise_smem();
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mla_partial_kernel<<<B * nsplit, kThreads, kSmem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mla_combine_kernel<<<B * kHeads, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

const char* mli_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
