// Fused-write paged decode attention and ring partial for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   min_llm_inference_tpu/ops/paged_attention_grouped.py ::
//   paged_decode_attention_grouped (kernel body _grouped_kernel)
// in its plain mode (a), its fused-write mode (b) and its ring-partial
// mode (c).
//
// Contract, for each slot b; token t of a slot sits in page table[b, t/P]
// (clamped into the pool for reads), row t % P, of a float32, bfloat16,
// int8 or packed int4 pool [NP, 2, P, Dk] (Dk = D/2 for int4; int8/int4
// with per-page f32 scales):
//   (a) o[b] = softmax(q . K[0:L]^T / sqrt(dh) * k_scale) . (v_scale * V)
//       over L = min(lengths[b], W*P) positions, float32;
//   (b) first quantize the raw new K and V rows against the ALREADY
//       UPDATED page scales, s > 0 ? clip(rint(x * (1/max(s, 1e-30))),
//       +-qmax) : 0, pack int4 per head as 16*hi + lo (a bfloat16 pool:
//       round to nearest even, no scales), and write the row in
//       place at pool[table[b, (L-1)/P], side, (L-1)%P] when that raw page
//       id is in [0, NP); then (a), the row just written included;
//   (c) the pool is read-only and holds positions < ring_start[b] (the
//       burst's own rows live in a ring merged outside the kernel): the
//       online-softmax partial o (normalized), m = max score, l = sum of
//       exp(score - m) per head over [0, ring_start) of a live slot. A live
//       slot with ring_start == 0 and a dead slot write o = 0, m = -inf,
//       l = 0 (the merge's coefficient of an empty partial is then exactly
//       0, never NaN) -- the flat kernel's function exactly.
// Dead slots (lengths == 0) read nothing of the pool, write nothing, and
// output exact zeros; their table rows may hold page ids of live slots.
//
// Bound on this card: bytes. Each live slot reads L K rows and L V rows of
// Dk bytes (int4: D/2) once and does ~4*L*D flops on them, about one flop
// per byte. The three modes are ring_partial.cuh's streaming template with
// TablePages in its Full, FusedWrite and Partial modes: one block per slot,
// tiles of a page's rows streamed by bulk copies through a shared-memory
// ring, an online softmax per tile, so shared memory does not grow with the
// context. The fused write quantizes with IEEE division and rintf (built
// without --use_fast_math), which gives the bytes of the plain version and
// of the JAX quantizer; the block never reads back its own global store.

#include "ring_partial.cuh"

extern "C" {

// The launcher. pool_kind: 0 float32, 1 int8, 2 packed int4 (int8 storage,
// Dk = D/2), 3 bfloat16; int8 and int4 take k_scales/v_scales [NP] f32. q, k_new and
// v_new are float32 (in_bf16 = 0) or bfloat16 (in_bf16 = 1) rows with the
// given row strides (elements) and unit inner stride; k_new == NULL selects
// mode (a), ring_start != NULL mode (c), which also writes m_out/l_out
// [B, H] (k_new must then be NULL). out [B, D] float32. Returns the
// cudaError_t of the launch (0 = launched).
int mli_grouped_attention(const void* q, long long q_stride, void* pool,
                          const int* lengths, const int* table,
                          const float* k_scales, const float* v_scales,
                          const void* k_new, long long kn_stride,
                          const void* v_new, long long vn_stride, float* out,
                          const int* ring_start, float* m_out, float* l_out,
                          int B, int D, int NP, int P, int W, int H,
                          int pool_kind, int in_bf16, float sm_scale,
                          void* stream) {
  if (ring_start != nullptr && k_new != nullptr) return cudaErrorInvalidValue;
  ring_partial::Args a = {};
  a.q = q;
  a.q_stride = q_stride;
  a.in_bf16 = in_bf16;
  a.pool = static_cast<unsigned char*>(pool);
  a.k_scales = k_scales;
  a.v_scales = v_scales;
  a.ring_start = ring_start;
  a.lengths = lengths;
  a.table = table;
  a.k_new = k_new;
  a.kn_stride = kn_stride;
  a.v_new = v_new;
  a.vn_stride = vn_stride;
  a.out = out;
  a.m_out = m_out;
  a.l_out = l_out;
  a.sm_scale = sm_scale;
  using ring_partial::TablePages;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ring_start != nullptr)
    return ring_partial::launch<TablePages, ring_partial::kPartial, true>(
        pool_kind, a, B, D, NP, P, W, H, s);
  if (k_new != nullptr)
    return ring_partial::launch<TablePages, ring_partial::kFusedWrite, true>(
        pool_kind, a, B, D, NP, P, W, H, s);
  return ring_partial::launch<TablePages, ring_partial::kFull, true>(
      pool_kind, a, B, D, NP, P, W, H, s);
}

// Shared memory bytes a launch needs, whatever the mode (-1: shapes the
// kernel does not take).
long long mli_grouped_attention_smem(int D, int H, int P, int pool_kind) {
  return ring_partial::smem_bytes(pool_kind, D, H, P);
}

const char* mli_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
