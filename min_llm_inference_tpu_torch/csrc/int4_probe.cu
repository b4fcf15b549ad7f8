// Probe: one packed int4 page copied into shared memory by one bulk copy,
// unpacked and multiplied by itself on the tensor cores, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   tools/int4_probe.py :: kernel
// which asked whether Mosaic could DMA one native-int4 page into VMEM,
// dequantize it and dot it with itself. Here the same question is asked of
// this card and of the port's int4 layout: page 0 of x [n, P, Dk] int8,
// each row D = 2*Dk int4 values packed as the port's pools pack one head
// (ops/quant.py: byte c = 16*hi + lo, lo = value c, hi = value c + Dk).
//
// One block of 8 warps:
//   1. thread 0 copies the page (P*Dk bytes) into shared memory with one
//      cp.async.bulk (the TMA without a tensor map), completing on an
//      mbarrier that every thread waits on;
//   2. the block unpacks every byte (hi = rint(b/16), half to even as the
//      plain version's torch.round; lo = b - 16*hi) into the [P, D] int8
//      values, rows padded by 16 bytes so that the fragment loads below hit
//      32 distinct banks;
//   3. the [P, P] product x . x^T runs on the tensor cores as
//      mma.sync.m16n8k32.row.col.s32.s8.s8.s32: (P/16) x (P/8) tiles of
//      m16n8 (8 at P = 32, one a warp), D/32 k-steps each (16 at D = 512);
//      A's rows and B's columns are both rows of the page, so every
//      fragment register is one 32-bit shared load of 4 values;
//   4. each int32 sum times 0.0625 (0.25 * 0.25) is written as float32.
// Exact by construction: |value| <= 8 (7 in the port's pools), so an int32
// sum is at most 512 * 64 = 32768 in size (25,088 for values in [-7, 7]),
// and times 0.0625 it is the float32 the plain version computes: every
// product of two quarter-integers and every partial sum of them is a
// multiple of 1/16 below 2^11, exact in float32 whatever the order of the
// sums. So the result equals unpack + torch.matmul bit for bit.
//
// Bound on this card: neither bytes nor operations (P*Dk bytes read and
// P*P*4 written, 12 KB at P = 32, Dk = 256; 2*P*P*D = 1 M int8 operations,
// ~0.5 ns on the tensor cores): the latency of one copy, one unpack and 16
// dependent mma steps on one SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPad = 16;  // bytes after each unpacked row

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

struct Smem {
  size_t bar, raw, vals, total;
  __host__ __device__ Smem(int P, int Dk) {
    size_t o = 0;
    bar = o; o += 16;
    raw = o; o += align16(size_t(P) * Dk);
    vals = o; o += size_t(P) * (2 * Dk + kPad);
    total = o;
  }
};

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
int4_probe_kernel(const int8_t* __restrict__ x, float* __restrict__ out,
                  int P, int Dk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay(P, Dk);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);
  const int8_t* raw = reinterpret_cast<const int8_t*>(smem + lay.raw);
  int8_t* vals = reinterpret_cast<int8_t*>(smem + lay.vals);
  const int tid = threadIdx.x;
  const int nbytes = P * Dk;
  const int D = 2 * Dk, ld = D + kPad;

  // ---- 1. one bulk copy of page 0, global -> shared ----
  if (tid == 0) {
    mbar_init(bar);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, static_cast<unsigned>(nbytes));
    bulk_load(smem + lay.raw, x, static_cast<unsigned>(nbytes), bar);
  }
  mbar_wait(bar, 0);

  // ---- 2. unpack 4 bytes a step into int8 values ----
  for (int i = tid * 4; i < nbytes; i += kThreads * 4) {
    const int row = i / Dk, c = i - row * Dk;
    const uint32_t w = ld32(raw + i);
    uint32_t lo4 = 0u, hi4 = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int b = static_cast<int8_t>(w >> (8 * q));
      const int hi = __float2int_rn(static_cast<float>(b) * 0.0625f);
      const int lo = b - 16 * hi;
      lo4 |= (static_cast<uint32_t>(lo) & 0xFFu) << (8 * q);
      hi4 |= (static_cast<uint32_t>(hi) & 0xFFu) << (8 * q);
    }
    *reinterpret_cast<uint32_t*>(vals + row * ld + c) = lo4;
    *reinterpret_cast<uint32_t*>(vals + row * ld + Dk + c) = hi4;
  }
  __syncthreads();

  // ---- 3. x . x^T on the tensor cores, one m16n8 tile a warp ----
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles_n = P / 8, n_tiles = (P / 16) * n_tiles_n;
  for (int tile = warp; tile < n_tiles; tile += kThreads / 32) {
    const int m0 = (tile / n_tiles_n) * 16, n0 = (tile % n_tiles_n) * 8;
    const int8_t* a_top = vals + (m0 + g) * ld + 4 * t;  // A rows g, g + 8
    const int8_t* a_bot = a_top + 8 * ld;
    const int8_t* b_col = vals + (n0 + g) * ld + 4 * t;  // B column g
    int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
    for (int k0 = 0; k0 < D; k0 += 32) {
      const uint32_t a0 = ld32(a_top + k0), a1 = ld32(a_bot + k0);
      const uint32_t a2 = ld32(a_top + k0 + 16), a3 = ld32(a_bot + k0 + 16);
      const uint32_t b0 = ld32(b_col + k0), b1 = ld32(b_col + k0 + 16);
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};"
          : "+r"(c0), "+r"(c1), "+r"(c2), "+r"(c3)
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
    // ---- 4. C fragment: rows g and g + 8, columns 2t and 2t + 1 ----
    float* o = out + (m0 + g) * P + n0 + 2 * t;
    o[0] = static_cast<float>(c0) * 0.0625f;
    o[1] = static_cast<float>(c1) * 0.0625f;
    o[8 * P] = static_cast<float>(c2) * 0.0625f;
    o[8 * P + 1] = static_cast<float>(c3) * 0.0625f;
  }
}

}  // namespace

extern "C" {

// The launcher of the kernel above: page 0 of x (P rows of Dk packed bytes,
// 16-byte aligned; P a multiple of 16, Dk a multiple of 16) -> out [P, P]
// float32. Returns the cudaError_t of the launch (0 = launched).
int mli_int4_probe(const void* x, float* out, int P, int Dk, void* stream) {
  if (P <= 0 || Dk <= 0 || P % 16 != 0 || Dk % 16 != 0)
    return cudaErrorInvalidValue;
  const Smem lay(P, Dk);
  if (lay.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        int4_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(lay.total));
    if (err != cudaSuccess) return err;
  }
  int4_probe_kernel<<<1, kThreads, lay.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), out, P, Dk);
  return cudaGetLastError();
}

// Shared memory bytes a launch of mli_int4_probe needs.
long long mli_int4_probe_smem(int P, int Dk) {
  return static_cast<long long>(Smem(P, Dk).total);
}

const char* mli_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
