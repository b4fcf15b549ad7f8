// Cross-slot ("flat") ring partial of paged decode attention, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   min_llm_inference_tpu/ops/paged_attention_flat.py ::
//   paged_decode_attention_flat (kernel body _flat_kernel)
//
// Contract. The pool [NP, 2, P, Dk] is float32, bfloat16, int8, or packed
// int4 (Dk = D/2, unpacked as ops/quant.py packs it), int8/int4 with
// per-page f32 scales. Token t of slot b sits in page table[b, t / P] (clamped into the
// pool), row t % P. Nothing assumes that a row's pages are contiguous:
// under overcommit a row is two independent half-groups, and an ungrown
// row's second half repeats its first (its positions never reach there).
// The partial itself (o, m, l over positions < ring_start; the empty
// partial o = 0, m = -inf, l = 0 for dead slots, whatever their
// ring_start, and for ring_start == 0; no pool read for them) is
// ring_partial.cuh's.
//
// Bound on this card: bytes. A live slot reads its ring_start K and V rows
// of Dk bytes once and does a few flops per byte on them: at the reference
// ring's shapes (1024 slots, emb 2048 in one head, packed int4) ~140-165 MB
// a call, ~0.05 ms at 3.35 TB/s. The TPU kernel's point is cross-slot work,
// so that the work per grid step does not depend on how lengths split
// across slots; its blocks of G slots, selector dots and DMA runs served
// its sequential grid. On this card the block scheduler balances: one
// block per slot streams that slot's rows, page by page through the table,
// in a ring of shared-memory stages filled by bulk copies, with an online
// softmax per tile (ring_partial.cuh says how). Shared memory does not grow
// with the context.

#include "ring_partial.cuh"

extern "C" {

// The launcher. pool_kind: 0 float32, 1 int8, 2 packed int4 (int8
// storage, Dk = D/2), 3 bfloat16; int8 and int4 take k_scales/v_scales
// [NP] f32. q is
// float32 (in_bf16 = 0) or bfloat16 (in_bf16 = 1) rows with row stride
// q_stride (elements) and unit inner stride. out [B, D], m_out and l_out
// [B, H] float32. Returns the cudaError_t of the launch (0 = launched).
int mli_flat_partial(const void* q, long long q_stride, const void* pool,
                     const int* lengths, const int* table,
                     const float* k_scales, const float* v_scales,
                     const int* ring_start, float* out, float* m_out,
                     float* l_out, int B, int D, int NP, int P, int W, int H,
                     int pool_kind, int in_bf16, float sm_scale,
                     void* stream) {
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
  return ring_partial::launch<ring_partial::TablePages, ring_partial::kPartial,
                              true>(pool_kind, a, B, D, NP, P, W, H,
                                     static_cast<cudaStream_t>(stream));
}

// Shared memory bytes a launch needs (-1: shapes the kernel does not take).
long long mli_flat_partial_smem(int D, int H, int P, int pool_kind) {
  return ring_partial::smem_bytes(pool_kind, D, H, P);
}

const char* mli_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
