// Ring-decode page partial over the full-grant group view, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   min_llm_inference_tpu/ops/paged_attention_dgrid.py ::
//   dgrid_paged_partial (kernel body _dgrid_kernel)
//
// Contract. Under the engine's group allocator a live slot's page-table
// row is gid*W + [0, W), so its context is ONE contiguous [W, 2, P, D]
// range of the pool [NP, 2, P, D] (float32, bfloat16, or int8 with
// per-page f32 scales); gid comes from the row's first entry, clamped into the pool.
// The partial itself (o, m, l over positions < ring_start; the empty
// partial o = 0, m = -inf, l = 0 for dead slots and ring_start == 0; no
// pool read for them) is ring_partial.cuh's.
//
// Bound on this card: bytes. A live slot reads its ring_start K and V rows
// of D bytes (int8) once and does ~4 flops per byte on them: at the gpt2s
// path's shapes (1024 slots, emb 768 in 12 heads, int8) ~90-110 MB a call,
// ~0.03 ms at 3.35 TB/s. The TPU kernel's mechanisms (group blocks of 32
// slots, the head-selector dot, scalar-prefetched per-block gating) served
// its MXU and DMA engine and are not carried over. Here one block streams
// one slot's rows through a ring of shared-memory stages filled by bulk
// copies, with an online softmax per tile (ring_partial.cuh says how), so
// shared memory does not grow with the context.

#include "ring_partial.cuh"

extern "C" {

// The launcher. pool_kind: 0 float32, 1 int8 (then k_scales/v_scales are
// [NP] f32), 3 bfloat16 (no scales). q is float32 (in_bf16 = 0) or bfloat16 (in_bf16 = 1) rows with
// row stride q_stride (elements) and unit inner stride. out [B, D],
// m_out/l_out [B, H] float32. Returns the cudaError_t of the launch
// (0 = launched).
int mli_dgrid_partial(const void* q, long long q_stride, const void* pool,
                      const float* k_scales, const float* v_scales,
                      const int* ring_start, const int* lengths,
                      const int* table, float* out, float* m_out, float* l_out,
                      int B, int D, int NP, int P, int W, int H, int pool_kind,
                      int in_bf16, float sm_scale, void* stream) {
  if (W <= 0 || NP % W != 0) return cudaErrorInvalidValue;
  ring_partial::Args a = {};
  a.q = q;
  a.q_stride = q_stride;
  a.in_bf16 = in_bf16;
  a.pool = static_cast<unsigned char*>(const_cast<void*>(pool));
  a.k_scales = k_scales;
  a.v_scales = v_scales;
  a.ring_start = ring_start;
  a.lengths = lengths;
  a.table = table;
  a.out = out;
  a.m_out = m_out;
  a.l_out = l_out;
  a.sm_scale = sm_scale;
  return ring_partial::launch<ring_partial::GroupPages, ring_partial::kPartial,
                              false>(pool_kind, a, B, D, NP, P, W, H,
                                     static_cast<cudaStream_t>(stream));
}

// Shared memory bytes a launch needs (-1: shapes the kernel does not take).
long long mli_dgrid_partial_smem(int D, int H, int P, int pool_kind) {
  return pool_kind == ring_partial::kI4
             ? -1
             : ring_partial::smem_bytes(pool_kind, D, H, P);
}

const char* mli_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
