// One-slot paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   min_llm_inference_tpu/ops/paged_attention.py ::
//   paged_decode_attention (kernel body _paged_decode_kernel),
// the attention of the host-scheduled PagedEngine (attention_impl="paged").
//
// Contract. For each slot b with L = min(lengths[b], W*P) > 0:
//   o[b, h] = softmax_t(q[b, h] . K[t, h] / sqrt(dh) * k_scale) .
//             (v_scale * V[t, h]),  t < L,
// as float32, token t read from page table[b, t / P] (clamped into the
// pool), row t % P, of a float32, bfloat16 or int8 pool [NP, 2, P, D]
// (int8 with per-page f32 scales). The table may be fragmented: nothing assumes that
// a row's pages are contiguous. Dead slots (L == 0) read nothing and output
// exact zeros: the host scheduler never clears a freed slot's table row,
// so a dead slot's row may hold page ids that now belong to a live slot.
// The JAX kernel scales K and V rows before the dots; here the scales
// multiply the score and the weight (the same value up to float32
// rounding, checked within 1e-4 of the plain version).
//
// Bound on this card: bytes. A live slot reads L K rows and L V rows of D
// elements once (int8 at the host path's shapes: 1024 slots, W*P = 128,
// D = 2048, one head) and does ~4*L*D flops on them, about 2 flops per
// byte. The TPU kernel's mechanisms (scalar prefetch, double-buffered page
// DMAs, the VMEM block chooser) have no counterpart here: the kernel is
// ring_partial.cuh's streaming template in its Full mode with TablePages
// (one block per slot, tiles of a page's rows streamed by bulk copies
// through a shared-memory ring, an online softmax per tile), so shared
// memory does not grow with the context.

#include "ring_partial.cuh"

extern "C" {

// The launcher. pool_kind: 0 float32, 1 int8 (then k_scales/v_scales [NP]
// f32 are required), 3 bfloat16 (no scales). q is float32 (in_bf16 = 0) or bfloat16 (in_bf16 = 1)
// rows with row stride q_stride (elements) and unit inner stride. out
// [B, D] float32. Returns the cudaError_t of the launch (0 = launched).
int mli_paged_attention(const void* q, long long q_stride, const void* pool,
                        const int* lengths, const int* table,
                        const float* k_scales, const float* v_scales,
                        float* out, int B, int D, int NP, int P, int W, int H,
                        int pool_kind, int in_bf16, float sm_scale,
                        void* stream) {
  ring_partial::Args a = {};
  a.q = q;
  a.q_stride = q_stride;
  a.in_bf16 = in_bf16;
  a.pool = static_cast<unsigned char*>(const_cast<void*>(pool));
  a.k_scales = k_scales;
  a.v_scales = v_scales;
  a.lengths = lengths;
  a.table = table;
  a.out = out;
  a.sm_scale = sm_scale;
  return ring_partial::launch<ring_partial::TablePages, ring_partial::kFull,
                              false>(pool_kind, a, B, D, NP, P, W, H,
                                     static_cast<cudaStream_t>(stream));
}

// Shared memory bytes a launch needs (-1: shapes the kernel does not take).
long long mli_paged_attention_smem(int D, int H, int P, int pool_kind) {
  return pool_kind == ring_partial::kI4
             ? -1
             : ring_partial::smem_bytes(pool_kind, D, H, P);
}

const char* mli_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
