// Probe: one packed int4 page loaded into shared memory with cp.async,
// dequantized and fed to a dot, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   tools/int4_probe.py :: kernel
// which asked whether Mosaic could DMA one native-int4 page into VMEM,
// dequantize it and dot it with itself. Here the same question is asked of
// this card and of the port's int4 layout: page 0 of x [n, P, Dk] int8,
// each row D = 2*Dk int4 values packed as the port's pools pack one head
// (ops/quant.py: byte c = 16*hi + lo, lo = value c, hi = value c + Dk).
//
// One block:
//   1. copies the page (P*Dk bytes) into shared memory with cp.async, 16
//      bytes a thread per copy, and waits for the group;
//   2. unpacks every byte (hi = rint(b/16), lo = b - 16*hi), multiplies by
//      0.25 and stores the [P, D] float32 page in shared memory (rows
//      padded by one float against bank conflicts);
//   3. writes out[i, j] = sum_k x[i, k] * x[j, k], the [P, P] float32
//      product x . x^T.
// Every product of two quarter-integers in [-7/4, 7/4] and every partial
// sum is exact in float32, so the result equals the plain version's bit for
// bit whatever the order of the sums.
//
// Bound on this card: operations. P*Dk bytes are read and P*P*4 written
// (12 KB at P = 32, Dk = 256), against 2*P*P*D = 1 MFLOP of float32 work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

struct Smem {
  size_t raw, deq, total;
  __host__ __device__ Smem(int P, int Dk) {
    size_t o = 0;
    raw = o; o += align16(size_t(P) * Dk);
    deq = o; o += align16(size_t(P) * (2 * Dk + 1) * 4);
    total = o;
  }
};

__global__ void __launch_bounds__(kThreads)
int4_probe_kernel(const int8_t* __restrict__ x, float* __restrict__ out,
                  int P, int Dk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay(P, Dk);
  int8_t* raw = reinterpret_cast<int8_t*>(smem + lay.raw);
  float* deq = reinterpret_cast<float*>(smem + lay.deq);
  const int tid = threadIdx.x;
  const int nbytes = P * Dk;
  const int D = 2 * Dk, ld = D + 1;

  // ---- 1. asynchronous copy of page 0, global -> shared ----
  for (int i = tid * 16; i < nbytes; i += kThreads * 16) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(raw + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(x + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // ---- 2. unpack + dequantize (x 0.25) ----
  for (int i = tid; i < nbytes; i += kThreads) {
    const int row = i / Dk, c = i - row * Dk;
    const float f = static_cast<float>(raw[i]);
    const float hi = rintf(f * 0.0625f);
    const float lo = f - 16.0f * hi;
    deq[row * ld + c] = lo * 0.25f;
    deq[row * ld + Dk + c] = hi * 0.25f;
  }
  __syncthreads();

  // ---- 3. out = x . x^T ----
  for (int o = tid; o < P * P; o += kThreads) {
    const int i = o / P, j = o - i * P;
    const float* a = deq + i * ld;
    const float* b = deq + j * ld;
    float acc = 0.0f;
    for (int k = 0; k < D; ++k) acc += a[k] * b[k];
    out[o] = acc;
  }
}

}  // namespace

extern "C" {

// The launcher of the kernel above: page 0 of x (P rows of Dk packed bytes,
// 16-byte aligned, P*Dk a multiple of 16) -> out [P, P] float32. Returns
// the cudaError_t of the launch (0 = launched).
int mli_int4_probe(const void* x, float* out, int P, int Dk, void* stream) {
  if (P <= 0 || Dk <= 0 || (size_t(P) * Dk) % 16 != 0) return cudaErrorInvalidValue;
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
