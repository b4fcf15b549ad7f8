// Ring flush for Hopper (sm_90a): land a burst's decode ring in its KV
// pages, in place.
//
// Replaces the Pallas TPU kernel
//   min_llm_inference_tpu/ops/ring_flush.py :: ring_flush
//   (kernel body _flush_kernel)
//
// Contract. ring [B, R, 2*row] (K row then V row, `row` bytes each),
// pool [NP, 2, P, row bytes]. A live slot's valid ring rows are columns
// r0 + i for i in [0, min(len - ring_start, n_rounds - r0)), holding
// position pos = ring_start + i, which lands at
// pool[table[b, pos / P], side, pos % P]. Rows of dead slots (len == 0)
// are skipped: their pages are freed at the next burst start and
// re-prefilled before anything reads them. n_rounds <= P, so a slot
// touches at most two pages, and no two live slots share a page.
//
// The kernel is a byte copy: it writes every pool byte the oracle
// (models/paged.flush_ring_to_pages) writes with the same value, for any
// element type. The TPU kernel fetched the <= 2 touched pages whole, rolled
// the ring under them and wrote whole pages back (tiled HBM forbids row
// writes there); on Hopper a row is written where it lands.
//
// Bound on this card: bytes, the valid rows read once from the ring and
// written once into the pool. One block per slot; its threads walk the
// (row, side, 16-byte chunk) triples so that neighbouring threads copy
// neighbouring bytes with 16-byte loads and stores (byte copies where a row
// is not a multiple of 16 bytes or a base is not 16-byte aligned).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void __launch_bounds__(kThreads)
ring_flush_kernel(V* __restrict__ pool, const V* __restrict__ ring,
                  const int* __restrict__ ring_start,
                  const int* __restrict__ ring_r0,
                  const int* __restrict__ lengths,
                  const int* __restrict__ table, int R, int W, int P, int NP,
                  int row, int n_rounds) {
  const int b = blockIdx.x;
  const int len = lengths[b];
  if (len <= 0) return;
  const int rs = ring_start[b];
  const int r0 = ring_r0 ? ring_r0[b] : 0;
  const int nv = min(len - rs, n_rounds - r0);
  if (nv <= 0 || rs < 0) return;
  const int per_row = 2 * row;  // V units of one K|V row pair
  for (int idx = threadIdx.x; idx < nv * per_row; idx += kThreads) {
    const int i = idx / per_row;
    const int rem = idx - i * per_row;
    const int side = rem / row;
    const int c = rem - side * row;
    const int pos = rs + i;
    const int col = pos / P;
    const int rc = r0 + i;
    if (col >= W || rc >= R) continue;
    const int page = table[static_cast<long long>(b) * W + col];
    if (page < 0 || page >= NP) continue;
    pool[((static_cast<long long>(page) * 2 + side) * P + pos % P) * row + c] =
        ring[(static_cast<long long>(b) * R + rc) * per_row + side * row + c];
  }
}

}  // namespace

extern "C" {

// The launcher of the kernel above. row_bytes: bytes of one K (or V) row,
// Dk * element size. ring_r0 may be NULL (every slot's first column is 0).
// vec16 = 1 when row_bytes % 16 == 0 and both bases are 16-byte aligned.
// Returns the cudaError_t of the launch (0 = launched).
int mli_ring_flush(void* pool, const void* ring, const int* ring_start,
                   const int* ring_r0, const int* lengths, const int* table,
                   int B, int R, int W, int P, int NP, int row_bytes,
                   int n_rounds, int vec16, void* stream) {
  if (B <= 0) return 0;
  if (n_rounds > R || n_rounds > P || row_bytes <= 0 || (vec16 && row_bytes % 16))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec16) {
    ring_flush_kernel<uint4><<<B, kThreads, 0, s>>>(
        static_cast<uint4*>(pool), static_cast<const uint4*>(ring), ring_start,
        ring_r0, lengths, table, R, W, P, NP, row_bytes / 16, n_rounds);
  } else {
    ring_flush_kernel<uint8_t><<<B, kThreads, 0, s>>>(
        static_cast<uint8_t*>(pool), static_cast<const uint8_t*>(ring),
        ring_start, ring_r0, lengths, table, R, W, P, NP, row_bytes, n_rounds);
  }
  return cudaGetLastError();
}

const char* mli_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
