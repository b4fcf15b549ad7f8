// Paged decode attention streamed page by page through shared memory with
// an online softmax, for Hopper (sm_90a). The device code of the port's
// four attention kernels: paged_attention.cu (one-slot, Full),
// paged_attention_grouped.cu (modes a Full, b FusedWrite, c Partial),
// paged_attention_dgrid.cu and paged_attention_flat.cu (Partial). They
// compute one function in three modes and differ only in how a slot finds
// its pages (a Pages policy: GroupPages or TablePages below).
//
// What it computes. The pool [NP, 2, P, Dk] (float32, bfloat16, int8, or
// packed int4 with Dk = D/2; int8/int4 with per-page f32 scales, the float
// kinds with none: k_scale = v_scale = 1). For each slot b with
// context length L > 0 and head h, over positions t < L:
//   s_t = (q . K_t) / sqrt(dh) * k_scale(page of t)
//   m = max_t s_t, l = sum_t exp(s_t - m),
//   o = sum_t exp(s_t - m) * v_scale(page of t) * V_t / l     (float32)
// The mode sets L and what is written:
//   Partial    L = ring_start[b] (clamped to W*P) for a live slot: o, m, l;
//   Full       L = min(lengths[b], W*P): o only;
//   FusedWrite as Full, but first the slot's raw k_new / v_new rows are
//              quantized against the ALREADY UPDATED page scales
//              (s > 0 ? clip(rint(x * (1 / max(s, 1e-30))), +-qmax) : 0,
//              IEEE division; int4 packed per head as 16*hi + lo; to a
//              bfloat16 pool rounded to nearest even, as a PyTorch or XLA
//              cast rounds) and
//              written in place at table[b, (L-1)/P], row (L-1) % P, when
//              that raw page id is in [0, NP); o covers the new row (when
//              it is not, nothing is written and row L-1 is read from the
//              clamped page, as the plain version reads it).
// A dead slot (lengths == 0) and a live slot with L == 0 read nothing of
// the pool, write nothing to it, and output o = 0 (Partial: m = -inf,
// l = 0): a dead slot's table row may hold live slots' pages. Page ids are
// clamped into the pool for reads.
//
// Bound on this card: bytes. A live slot reads its L K rows and L V rows
// (Dk bytes each for int8/int4) and does ~4 flops per byte on them, far
// below what the card's float32 units do per byte of HBM bandwidth. What
// the design does about it:
//   * one block of 4 warps per slot (the block scheduler balances the
//     slots' unequal contexts), three blocks an SM; the block streams its
//     rows in tiles of TR rows of one page (K rows and V rows, each run one
//     contiguous range of the pool, at most 32 KB a tile) through a ring of
//     2-8 shared-memory stages (64 KB), each filled by 1-D bulk copies
//     (cp.async.bulk, the TMA without a tensor map) completing on an
//     mbarrier. Only the context's rows are copied;
//   * an online softmax per tile: running m, l and o per head, o rescaled
//     when a tile raises m, the V page scale folded into the tile's weights.
//     Shared memory does not grow with the context (W*P);
//   * 16-byte shared-memory reads: a (row, head) dot is split over S lanes
//     (S = 4 at 64 int8 features a head: 8 dots a warp, 2 shuffles each),
//     each lane keeping four independent sums; in P.V a thread owns 16
//     bytes of the V row and walks the tile's rows. Each quarter-warp reads
//     128 contiguous bytes (q is stored transposed by 16-byte chunk), so
//     reads do not conflict without padding;
//   * int8 (and int4) bytes become floats without the conversion unit
//     (a quarter of the float rate): the byte, offset by 128, is placed in
//     the mantissa of 2^23 by one byte permute and the offset subtracted;
//     a bfloat16 is the high half of its float32, so a 4-byte word of two
//     widens by one shift and one mask;
//   * the fused write never reads back its own global store: the bulk
//     copies stop before the new row, and the block puts the row's bytes
//     into the stage itself (generic stores, into bytes no copy writes)
//     once that stage is handed to the last tile;
//   * rows wider than one block's 4096 features (128 threads x 32
//     accumulators) are cut into feature slices, one block each, launched
//     as a thread block cluster (a separate instantiation, so unsliced
//     rows pay nothing for it): each block stages and dots only its slice
//     and the blocks sum their partial dots through distributed shared
//     memory (one cluster barrier a tile) before the softmax, which every
//     block then computes alike.
// At one head of 2048 features the in-block arithmetic, not the copies,
// sets the time (PERF.md: the kernel ~1.1x its arithmetic alone, ~1.4x its
// copies alone). Shapes the 16-byte path does not fit (a head's row
// segment not a multiple of 16 bytes) take 4- or 1-byte reads; rows not a
// multiple of 16 bytes are copied by plain loads into one stage.
//
// RING_PARTIAL_SPLIT (a compile-time switch, 0 when not set) builds the
// timing variants that chip_smoke.py compares with the kernel: 1 = the
// copies alone (warp 0 waits for each tile and refills its stage, nothing
// is computed), 2 = the arithmetic alone (the first stages' tiles are
// copied once and every tile computes on them, no refills). Their outputs
// are meaningless.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <mutex>

#include "bulk_copy.cuh"

#ifndef RING_PARTIAL_SPLIT
#define RING_PARTIAL_SPLIT 0
#endif

namespace ring_partial {
// Internal linkage: the kernel libraries that include this header are loaded
// into one process, and a template's function-local statics (the attributes
// set per device in run()) would otherwise be shared between them.
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 32;                // P.V accumulators a thread holds
constexpr int kMaxStages = 8;
constexpr int kMaxSlices = 16;          // blocks of a cluster (non-portable > 8)
constexpr int kTileBudget = 32 * 1024;  // bytes of one tile (K + V rows)
constexpr int kRingBudget = 64 * 1024;  // bytes of the stage ring
constexpr int kHeader = 256;            // mbarriers and per-stage page info
constexpr int kMaxSmem = 232448;        // dynamic shared memory of a block

// kind numbers are the launchers' pool_kind: new kinds go at the end
enum PoolKind { kF32 = 0, kI8 = 1, kI4 = 2, kBF16 = 3 };
enum Mode { kPartial = 0, kFull = 1, kFusedWrite = 2 };

// The shapes of one launch and its shared-memory layout, made on the host.
struct Plan {
  int D, H, P, W, NP;
  int row_b;      // bytes of one pool row (Dk elements)
  int head_b;     // bytes of one head's segment of a row
  int vb;         // bytes a lane reads at once: 16, 4, 2 (bf16) or 1 (int8)
  int nch;        // chunks (vb bytes) of one head
  int slices;     // blocks a slot (a cluster when > 1)
  int slice_c;    // chunks of a row one block owns (the last may own fewer)
  int slice_b;    // slice_c * vb: a staged row's stride in a stage
  int heads_b;    // most heads one block's chunks touch
  int tile_rows;  // rows of a page per tile (divides P)
  int tile_b;     // bytes of one stage
  int stages;     // stages of the ring (1 without bulk copies)
  int bulk;       // tiles arrive by cp.async.bulk
  int ring_off, q_off, sc_off, hs_off, smem;
};

// The pointers and scalars of one launch (unused ones null).
struct Args {
  const void* q;
  long long q_stride;
  int in_bf16;                 // q, k_new, v_new: bfloat16 (else float32)
  unsigned char* pool;         // written by FusedWrite only
  const float* k_scales;
  const float* v_scales;
  const int* ring_start;       // Partial
  const int* lengths;
  const int* table;
  const void* k_new;           // FusedWrite: raw new rows [B, D]
  long long kn_stride;
  const void* v_new;
  long long vn_stride;
  float* out;
  float* m_out;                // Partial
  float* l_out;
  float sm_scale;
};

struct TileInfo {
  int pid;
  float ks, vs;
  int pad;
};

inline int align_up(long long n, int a) {
  return static_cast<int>((n + a - 1) / a * a);
}

// False when the kernel does not take the shapes.
inline bool make_plan(Plan& p, int kind, int D, int H, int P, int W, int NP,
                      bool pool_16b) {
  if (kind < kF32 || kind > kBF16 || D <= 0 || H <= 0 || D % H || P <= 0 ||
      W <= 0 || NP <= 0)
    return false;
  if (kind == kI4 && (D / H) % 2) return false;
  const int esz = kind == kF32 ? 4 : kind == kBF16 ? 2 : 1;
  p.D = D; p.H = H; p.P = P; p.W = W; p.NP = NP;
  p.row_b = (kind == kI4 ? D / 2 : D) * esz;
  p.head_b = p.row_b / H;
  // a chunk never splits an element: a bfloat16 head of odd width reads
  // 2 bytes at once
  p.vb = p.head_b % 16 == 0 ? 16 : p.head_b % 4 == 0 ? 4 : esz;
  p.nch = p.head_b / p.vb;
  const int nc = p.row_b / p.vb;
  // features of one chunk, and the chunks one block can own
  const int fpc = p.vb / esz * (kind == kI4 ? 2 : 1);
  const int max_c = kThreads * (kAcc / fpc);
  p.slices = (nc + max_c - 1) / max_c;
  if (p.slices > kMaxSlices) return false;
  p.slice_c = (nc + p.slices - 1) / p.slices;
  if ((p.slices - 1) * p.slice_c >= nc) return false;
  p.slice_b = p.slice_c * p.vb;
  p.heads_b = p.slices == 1
                  ? H
                  : (H < (p.slice_c + p.nch - 2) / p.nch + 1
                         ? H
                         : (p.slice_c + p.nch - 2) / p.nch + 1);
  int split = static_cast<int>(
      (2LL * P * p.slice_b + kTileBudget - 1) / kTileBudget);
  if (split < 1) split = 1;
  while (P % split) ++split;
  p.tile_rows = P / split;
  p.tile_b = align_up(2LL * p.tile_rows * p.slice_b, 128);
  p.bulk = pool_16b && p.row_b % 16 == 0 && p.slice_b % 16 == 0;
  p.stages = 1;
  if (p.bulk) {
    p.stages = kRingBudget / p.tile_b;
    p.stages = p.stages < 2 ? 2 : p.stages > kMaxStages ? kMaxStages : p.stages;
  }
  // after the last tile the ring holds the P.V row groups' partial sums
  const int groups = p.slice_c <= kThreads ? kThreads / p.slice_c : 1;
  const long long red_b = 4LL * (groups - 1) * p.slice_c * fpc;
  long long ring_b = 1LL * p.stages * p.tile_b;
  if (red_b > ring_b) ring_b = red_b;
  // scores (sliced: also two buffers of partial dots) and head state
  const int sc_n = (p.slices > 1 ? 3 : 1) * p.heads_b * p.tile_rows;
  long long o = kHeader;
  p.ring_off = static_cast<int>(o); o += align_up(ring_b, 128);
  p.q_off = static_cast<int>(o);    o += align_up(4LL * p.slice_c * fpc, 16);
  p.sc_off = static_cast<int>(o);   o += align_up(4LL * sc_n, 16);
  p.hs_off = static_cast<int>(o);   o += align_up(12LL * p.heads_b, 16);
  if (o > kMaxSmem) return false;
  p.smem = static_cast<int>(o);
  return true;
}

// dgrid: a live slot's pages are one contiguous group gid*W + [0, W), gid
// read from the row's first entry and clamped into the pool.
struct GroupPages {
  static __device__ int raw(const int* table, int b, int W, int NP, int w) {
    const int gid = table[static_cast<long long>(b) * W] / W;
    return min(max(gid, 0), NP / W - 1) * W + w;
  }
};

// page w of slot b is table[b, w] (clamped into the pool for reads); any
// table (full groups, overcommit's half-groups, fragmented rows).
struct TablePages {
  static __device__ int raw(const int* table, int b, int W, int, int w) {
    return table[static_cast<long long>(b) * W + w];
  }
};

// ---------------------------------------------------------------- math

// Byte k of u (= four signed bytes ^ 0x80808080) as an exact float: the
// byte, offset by 128, becomes the low mantissa bits of 2^23.
__device__ __forceinline__ float byte_f(unsigned u, int k) {
  return __fsub_rn(__int_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | k)),
                   8388736.0f);
}

// One unit of U bytes (4, or 2 or 1 on the narrow paths) as floats:
// x[0, EU) the values (int4: the lo values), x[EU, 2*EU) the int4 hi
// values. int4 is unpacked as ops/quant.py packs it: hi =
// round-half-even(byte / 16), lo = byte - 16 * hi (the 1.5 * 2^23 addend
// rounds to an integer). bfloat16 widens exactly: its bits are the high
// half of the float32 (element 0 is the low half of the word).
template <int KIND, int U>
__device__ __forceinline__ void decode(unsigned w, float* x) {
  if constexpr (KIND == kF32) {
    x[0] = __uint_as_float(w);
  } else if constexpr (KIND == kBF16) {
    x[0] = __uint_as_float(w << 16);
    if constexpr (U == 4) x[1] = __uint_as_float(w & 0xffff0000u);
  } else {
    float f[U];
    if constexpr (U == 4) {
      const unsigned u = w ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < 4; ++k) f[k] = byte_f(u, k);
    } else {
      f[0] = static_cast<float>(static_cast<signed char>(w & 0xffu));
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if constexpr (KIND == kI4) {
        const float hi =
            __fsub_rn(__fmaf_rn(f[k], 0.0625f, 12582912.0f), 12582912.0f);
        x[k] = __fmaf_rn(-16.0f, hi, f[k]);
        x[U + k] = hi;
      } else {
        x[k] = f[k];
      }
    }
  }
}

// The VB bytes of one chunk at p (VB-aligned shared memory) as NU units.
template <int VB, int NU>
__device__ __forceinline__ void load_chunk(const unsigned char* p,
                                           unsigned (&w)[NU]) {
  if constexpr (VB == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (VB == 4) {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  } else if constexpr (VB == 2) {
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  } else {
    w[0] = *p;
  }
}

// part[e % 4] += q[e] * x[e] over one unit: four independent sums, so a
// lane's chain of dependent multiply-adds is a quarter as long.
template <int EU>
__device__ __forceinline__ void dot_unit(const float* qp, const float* x,
                                         float (&part)[4]) {
  if constexpr (EU == 4) {
    const float4 v = *reinterpret_cast<const float4*>(qp);
    part[0] = fmaf(v.x, x[0], part[0]);
    part[1] = fmaf(v.y, x[1], part[1]);
    part[2] = fmaf(v.z, x[2], part[2]);
    part[3] = fmaf(v.w, x[3], part[3]);
  } else {
#pragma unroll
    for (int e = 0; e < EU; ++e) part[e] = fmaf(qp[e], x[e], part[e]);
  }
}

// The feature of q / o that element e of unit k of chunk c holds in plane
// p (int4: 0 = lo, 1 = hi values; else 0).
template <int KIND, int NE, int EU>
__device__ __forceinline__ int feature_of(int c, int k, int e, int p,
                                          int dhk) {
  const int s = c * NE + k * EU + e;  // storage element of the row
  if constexpr (KIND == kI4) {
    const int h = s / dhk;
    return h * 2 * dhk + (s - h * dhk) + p * dhk;
  } else {
    return s;
  }
}

__device__ __forceinline__ float in_value(const void* p, long long i,
                                          int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float quant(float x, float inv, float qmax) {
  return fminf(fmaxf(rintf(x * inv), -qmax), qmax);
}

// ---------------------------------------------------------------- kernel

template <int KIND, int VB, int MODE, class Pages, bool kSliced>
__global__ void __launch_bounds__(kThreads, 3)
attention_kernel(const Args a, const Plan pl) {
  constexpr bool kQuant = KIND == kI8 || KIND == kI4;   // per-page scales
  constexpr bool kPacked = KIND == kI4;
  constexpr bool kFused = MODE == kFusedWrite;
  // bytes of a storage element
  constexpr int ESZ = KIND == kF32 ? 4 : KIND == kBF16 ? 2 : 1;
  constexpr int U = VB < 4 ? VB : 4;          // bytes decoded at once
  constexpr int NU = VB / U;                  // units per chunk
  constexpr int EU = U / ESZ;                 // storage elements per unit
  constexpr int NE = NU * EU;                 // storage elements per chunk
  constexpr int FU = kPacked ? 2 * EU : EU;   // features per unit
  constexpr int FPC = NU * FU;                // features per chunk
  constexpr int CPT = kAcc / FPC;             // chunks a thread may own

  // kSliced: pl.slices blocks (a cluster) share a slot, block `rank` owning
  // a slice of slice_c chunks of every row
  const int nsl = kSliced ? pl.slices : 1;
  const int b = kSliced ? blockIdx.x / nsl : blockIdx.x;
  const int rank = kSliced ? blockIdx.x - b * nsl : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = pl.D, H = pl.H, P = pl.P, W = pl.W, NP = pl.NP;
  const int TR = pl.tile_rows, row_b = pl.row_b;
  const int NCH = pl.nch, NC = row_b / VB;
  const int cs0 = kSliced ? rank * pl.slice_c : 0;   // the block's chunks
  const int NCs = kSliced ? min(pl.slice_c, NC - cs0) : NC;
  const int sb = NCs * VB;                        // bytes of a row it stages
  const int SB = kSliced ? pl.slice_b : row_b;    // a staged row's stride
  const int h_lo = kSliced ? cs0 / NCH : 0;       // its heads
  const int Hs = kSliced ? (cs0 + NCs - 1) / NCH - h_lo + 1 : H;
  const int dhk = pl.head_b / ESZ;
  const long long bD = static_cast<long long>(b) * D;
  // local feature i of the slice (q's transposed layout: plane p, unit k,
  // chunk c, element e at ((p * NU + k) * NCs + c) * EU + e) -> feature
  auto slice_feature = [&](int i) {
    const int e = i % EU;
    const int c = (i / EU) % NCs;
    const int k = (i / (EU * NCs)) % NU;
    const int p = i / (EU * NCs * NU);
    return feature_of<KIND, NE, EU>(cs0 + c, k, e, p, dhk);
  };

  // warp 0 holds the page ids (clamped into the pool) and scales of a
  // window of 32 pages, one a lane. It reads the first window's ids before
  // it knows whether the slot is live (a dead slot's table row may be read,
  // never the pool), so that the first copies wait on one round trip to
  // memory, not three.
  auto page_id = [&](int w) {
    return min(max(Pages::raw(a.table, b, W, NP, w), 0), NP - 1);
  };
  int win = 0, my_pid = 0;
  float my_ks = 1.0f, my_vs = 1.0f;
  if (warp == 0 && lane < W) my_pid = page_id(lane);
  int L;
  if constexpr (MODE == kPartial)
    L = a.lengths[b] > 0 ? min(max(a.ring_start[b], 0), W * P) : 0;
  else
    L = min(max(a.lengths[b], 0), W * P);
  if (L == 0) {
    if constexpr (kSliced) {
      for (int i = tid; i < NCs * FPC; i += kThreads)
        a.out[bD + slice_feature(i)] = 0.0f;
    } else {
      for (int c = tid; c < D; c += kThreads) a.out[bD + c] = 0.0f;
    }
    if constexpr (MODE == kPartial) {
      if (rank == 0) {
        for (int h = tid; h < H; h += kThreads) {
          a.m_out[static_cast<long long>(b) * H + h] = -CUDART_INF_F;
          a.l_out[static_cast<long long>(b) * H + h] = 0.0f;
        }
      }
    }
    return;
  }

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  TileInfo* info = reinterpret_cast<TileInfo*>(smem + 8 * kMaxStages);
  unsigned char* ring = smem + pl.ring_off;
  float* qT = reinterpret_cast<float*>(smem + pl.q_off);
  float* sc = reinterpret_cast<float*>(smem + pl.sc_off);  // [Hs][TR]
  float* scp = sc + pl.heads_b * TR;         // sliced: partial dots, 2 buffers
  float* hm = reinterpret_cast<float*>(smem + pl.hs_off);
  float* hl = hm + pl.heads_b;
  float* ha = hl + pl.heads_b;

  const int n_tiles = (L + TR - 1) / TR;
  const int n_pages = (L + P - 1) / P;
  const int stages = pl.stages;
  const int t_last = n_tiles - 1;

  // FusedWrite: the new row sits at position L-1, the last row of the last
  // tile. own: its raw page id is in the pool, so the row is written there
  // and the block supplies it to the stage itself; otherwise nothing is
  // written and the row is read from the (clamped) pool like any other.
  const int pos = L - 1;
  int own_pid = 0;
  bool own = false;
  if constexpr (kFused) {
    own_pid = Pages::raw(a.table, b, W, NP, pos / P);
    own = own_pid >= 0 && own_pid < NP;
  }
  // the VB bytes of chunk c of the new row's side (0 K, 1 V), as NU words
  auto new_words = [&](int side, int c, unsigned (&w)[NU]) {
    const void* src = side ? a.v_new : a.k_new;
    const long long base = b * (side ? a.vn_stride : a.kn_stride);
    float inv = 0.0f;
    if constexpr (kQuant) {
      const float sv = (side ? a.v_scales : a.k_scales)[own_pid];
      inv = sv > 0.0f ? 1.0f / fmaxf(sv, 1e-30f) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      w[k] = 0;
#pragma unroll
      for (int e = 0; e < EU; ++e) {
        const int f = feature_of<KIND, NE, EU>(cs0 + c, k, e, 0, dhk);
        const float x = in_value(src, base + f, a.in_bf16);
        if constexpr (KIND == kF32) {
          w[k] = __float_as_uint(x);
        } else if constexpr (KIND == kBF16) {
          w[k] |= static_cast<unsigned>(
                      __bfloat16_as_ushort(__float2bfloat16_rn(x)))
                  << (16 * e);
        } else {
          float v = quant(x, inv, kPacked ? 7.0f : 127.0f);
          if constexpr (kPacked)
            v = 16.0f * quant(in_value(src, base + f + dhk, a.in_bf16), inv,
                              7.0f) + v;
          w[k] |= (static_cast<unsigned>(static_cast<int>(v)) & 0xffu)
                  << (8 * e);
        }
      }
    }
  };
  // the new row's K and V bytes of this block's slice, a thread a chunk at a
  // time (the chunks it owns in P.V): quantized once into the pool
  // (to_pool), and into row n-1 of stage s (s >= 0) now or later; int8 and
  // int4 words are kept in registers between the two, float32 and bfloat16
  // ones (up to 32 a side) are read again
  unsigned kept[2][kQuant ? CPT : 1][NU];
  auto put_new_row = [&](bool to_pool, int s) {
    if constexpr (kFused) {
      const bool pool_vec = reinterpret_cast<uintptr_t>(a.pool) % VB == 0;
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        unsigned char* dst =
            a.pool + ((static_cast<long long>(own_pid) * 2 + side) * P +
                      pos % P) * row_b + cs0 * VB;
        unsigned char* st =
            s < 0 ? nullptr
                  : ring + s * pl.tile_b + (side * TR + pos - t_last * TR) * SB;
#pragma unroll
        for (int kc = 0; kc < CPT; ++kc) {
          const int c = tid + kc * kThreads;
          if (c >= NCs) continue;
          unsigned w[NU];
          if constexpr (kQuant) {
            if (to_pool) new_words(side, c, kept[side][kc]);
#pragma unroll
            for (int k = 0; k < NU; ++k) w[k] = kept[side][kc][k];
          } else {
            new_words(side, c, w);
          }
          if (st) {
            if constexpr (VB == 16)
              *reinterpret_cast<uint4*>(st + c * VB) =
                  make_uint4(w[0], w[1], w[2], w[3]);
            else if constexpr (VB == 4)
              *reinterpret_cast<unsigned*>(st + c * VB) = w[0];
            else if constexpr (VB == 2)
              *reinterpret_cast<unsigned short*>(st + c * VB) =
                  static_cast<unsigned short>(w[0]);
            else
              st[c] = static_cast<unsigned char>(w[0]);
          }
          if (to_pool) {
            if (pool_vec && VB == 16) {
              *reinterpret_cast<uint4*>(dst + c * VB) =
                  make_uint4(w[0], w[1], w[2], w[3]);
            } else {
#pragma unroll
              for (int i = 0; i < VB; ++i)
                dst[c * VB + i] =
                    static_cast<unsigned char>(w[i / 4] >> (8 * (i % 4)));
            }
          }
        }
      }
    }
  };

  // the scales of the window's pages (warp 0)
  auto load_scales = [&]() {
    if constexpr (kQuant) {
      if (win + lane < n_pages) {
        my_ks = a.k_scales[my_pid];
        my_vs = a.v_scales[my_pid];
      }
    }
  };
  // tile t's page id and scales into info[t % stages]; returns the page id
  // (warp 0, converged)
  auto publish = [&](int t) {
    const int w = t * TR / P;
    if (w >= win + 32) {                       // contexts past 32 pages
      win = w & ~31;
      if (win + lane < n_pages) my_pid = page_id(win + lane);
      load_scales();
    }
    const int pid = __shfl_sync(0xffffffffu, my_pid, w - win);
    const float ks = __shfl_sync(0xffffffffu, my_ks, w - win);
    const float vs = __shfl_sync(0xffffffffu, my_vs, w - win);
    if (lane == 0) info[t % stages] = TileInfo{pid, ks, vs, 0};
    return pid;
  };
  // rows of tile t that come from the pool (the new row of an owned fused
  // write does not)
  auto pool_rows = [&](int t) {
    return min(TR, L - t * TR) - (own && t == t_last ? 1 : 0);
  };
  // tile t's K and V rows of page pid into stage t % stages: bulk copies
  // completing on the stage's mbarrier (lane 0 of warp 0); one copy a side
  // for a whole row, one a side and row for a slice
  auto copy = [&](int t, int pid) {
    const int s = t % stages;
    const int r0 = t * TR - (t * TR / P) * P;
    const int rows = pool_rows(t);
    const unsigned char* k_src =
        a.pool + (static_cast<long long>(pid) * 2 * P + r0) * row_b + cs0 * VB;
    unsigned char* dst = ring + s * pl.tile_b;
    const long long vo = static_cast<long long>(P) * row_b;
    fence_proxy_async();
    mbar_expect_tx(&bars[s], 2u * rows * sb);
    if constexpr (!kSliced) {
      if (rows > 0) {
        const unsigned bytes = static_cast<unsigned>(rows) * row_b;
        bulk_load(dst, k_src, bytes, &bars[s]);
        bulk_load(dst + TR * SB, k_src + vo, bytes, &bars[s]);
      }
    } else {
      for (int r = 0; r < rows; ++r) {
        bulk_load(dst + r * SB, k_src + static_cast<long long>(r) * row_b, sb,
                  &bars[s]);
        bulk_load(dst + (TR + r) * SB,
                  k_src + vo + static_cast<long long>(r) * row_b, sb,
                  &bars[s]);
      }
    }
  };

  if (warp == 0) {
    // the ring's first tiles lie in pages < stages <= 32: their ids are here
    const int first = min(stages, n_tiles);
    if (pl.bulk) {
      for (int t = 0; t < first; ++t) {
        const int pid = __shfl_sync(0xffffffffu, my_pid, t * TR / P);
        if (lane == 0) {
          if (t == 0) {
            for (int s = 0; s < stages; ++s) mbar_init(&bars[s]);
            fence_mbar_init();
          }
          copy(t, pid);
        }
      }
    }
    load_scales();
    for (int t = 0; t < first; ++t) publish(t);
  }
  // the fused write; when the last tile is among the first stages' (a stage
  // no earlier tile uses), its new row goes into that stage now
  if (own) put_new_row(true, pl.bulk && t_last < stages ? t_last : -1);
  // q, transposed by chunk, so that lanes on consecutive chunks read
  // consecutive 16-byte words
  for (int i = tid; i < NCs * FPC; i += kThreads)
    qT[i] = in_value(a.q, b * a.q_stride + slice_feature(i), a.in_bf16);
  for (int h = tid; h < Hs; h += kThreads) {
    hm[h] = -CUDART_INF_F;
    hl[h] = 0.0f;
  }
  __syncthreads();

  int S = 1;                           // lanes per (row, head) dot
  while (S < NCH && S < 32) S <<= 1;
  const int dpw = 32 / S;              // dots per warp per pass
  const int step = kWarps * dpw;       // dots per pass
  const int step_r = step / Hs, step_h = step - step_r * Hs;
  const int d_first = warp * dpw + lane / S, li = lane & (S - 1);
  const int r_first = d_first / Hs, h_first = d_first - r_first * Hs;
  int LH = 1;                          // softmax lanes per head
  while (LH < TR && LH < 32) LH <<= 1;
  const int hpw = 32 / LH;             // heads per warp per round
  const bool wide = NCs > kThreads;    // a thread owns several chunks
  const int G = wide ? 1 : kThreads / NCs;   // P.V row groups
  const int g = wide ? 0 : tid / NCs;
  const int c0 = wide ? tid : tid - g * NCs;
  float acc[CPT][FPC];
#pragma unroll
  for (int kc = 0; kc < CPT; ++kc)
#pragma unroll
    for (int i = 0; i < FPC; ++i) acc[kc][i] = 0.0f;

#if RING_PARTIAL_SPLIT == 1
  // the copies alone: warp 0 waits for every tile and refills its stage
  if (pl.bulk && warp == 0) {
    for (int t = 0; t < n_tiles; ++t) {
      mbar_wait(&bars[t % stages], (t / stages) & 1);
      if (t + stages < n_tiles) {
        const int pid = publish(t + stages);
        if (lane == 0) copy(t + stages, pid);
      }
    }
  }
  if (pl.bulk) goto epilogue;
#endif
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % stages;
    const int n = min(TR, L - t * TR);
    const unsigned char* kt = ring + s * pl.tile_b;
    const unsigned char* vt = kt + TR * SB;
    if (pl.bulk) {
#if RING_PARTIAL_SPLIT == 2
      if (t < stages)
#endif
        mbar_wait(&bars[s], (t / stages) & 1);
    } else {
      // one stage, filled by plain loads: rows that bulk copies cannot move
      if (warp == 0 && t > 0) publish(t);
      __syncthreads();
      const int w = t * TR / P;
      const unsigned char* k_src =
          a.pool +
          (static_cast<long long>(info[0].pid) * 2 * P + t * TR - w * P) *
              row_b + cs0 * VB;
      const int rows = pool_rows(t);
      if constexpr (kSliced) {
        for (int i = tid; i < rows * sb; i += kThreads) {
          const int r = i / sb, o = i - r * sb;
          ring[r * SB + o] = k_src[static_cast<long long>(r) * row_b + o];
          ring[(TR + r) * SB + o] =
              k_src[static_cast<long long>(P + r) * row_b + o];
        }
      } else {
        for (int i = tid; i < rows * row_b; i += kThreads) {
          ring[i] = k_src[i];
          ring[TR * row_b + i] = k_src[static_cast<long long>(P) * row_b + i];
        }
      }
      if (own && t == t_last) put_new_row(false, 0);
      __syncthreads();
    }
    const float ks = info[s].ks, vs = info[s].vs;
    float* dots = kSliced ? scp + (t & 1) * pl.heads_b * TR : sc;

    // ---- dots of the tile's n rows, every head of the block: S lanes a
    // dot, four independent sums a lane ----
    int r = r_first, h = h_first;
    for (int d0 = warp * dpw; d0 < n * Hs; d0 += step) {
      const bool valid = d0 + lane / S < n * Hs;
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (valid) {
        const unsigned char* kr = kt + r * SB;
        auto dot_chunk = [&](int c) {
          unsigned wv[NU];
          load_chunk<VB, NU>(kr + c * VB, wv);
#pragma unroll
          for (int k = 0; k < NU; ++k) {
            float x[FU];
            decode<KIND, U>(wv[k], x);
            dot_unit<EU>(qT + (k * NCs + c) * EU, x, part);
            if constexpr (kPacked)
              dot_unit<EU>(qT + ((NU + k) * NCs + c) * EU, x + EU, part);
          }
        };
        if constexpr (kSliced) {
          // the head's chunks within the slice, as local chunk indices
          const int jb = min((h_lo + h + 1) * NCH, cs0 + NCs) - cs0;
          for (int c = max((h_lo + h) * NCH, cs0) - cs0 + li; c < jb; c += S)
            dot_chunk(c);
        } else {
          for (int j = li; j < NCH; j += S) dot_chunk(h * NCH + j);
        }
      }
      float dot = (part[0] + part[1]) + (part[2] + part[3]);
      for (int o = S >> 1; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (valid && li == 0)
        dots[h * TR + r] = kSliced ? dot : dot * a.sm_scale * ks;
      r += step_r;                     // the next pass's dot: d + step
      h += step_h;
      if (h >= Hs) {
        h -= Hs;
        ++r;
      }
    }
    __syncthreads();
    if constexpr (kSliced) {
      // the slices' partial dots summed in rank order (every block alike)
      // through distributed shared memory; the buffers alternate by tile,
      // so a block's next write to one follows the next cluster barrier,
      // which every reader reaches after reading it
      cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
      cl.sync();
      for (int i = tid; i < Hs * n; i += kThreads) {
        const int hh = i / n, rr = i - hh * n;
        const int hg = h_lo + hh;
        const int q0 = hg * NCH / pl.slice_c;
        const int q1 = min(((hg + 1) * NCH - 1) / pl.slice_c, nsl - 1);
        float sum = 0.0f;
        for (int qr = q0; qr <= q1; ++qr) {
          const float* peer = cl.map_shared_rank(dots, qr);
          sum += peer[(hg - qr * pl.slice_c / NCH) * TR + rr];
        }
        sc[hh * TR + rr] = sum * a.sm_scale * ks;
      }
      __syncthreads();
    }

    // ---- online softmax, LH lanes a head (the tile's rows, at most 32),
    // several heads a warp: m, l, the rescale of o, and the tile's weights
    // (V page scale folded in) ----
    for (int h0 = warp * hpw; h0 < Hs; h0 += kWarps * hpw) {
      const int hh = h0 + lane / LH, lr = lane & (LH - 1);
      const bool vh = hh < Hs;
      float* sh = sc + (vh ? hh : 0) * TR;
      float mt = -CUDART_INF_F;
      if (vh)
        for (int rr = lr; rr < n; rr += LH) mt = fmaxf(mt, sh[rr]);
      for (int o = LH >> 1; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = vh ? hm[hh] : 0.0f;
      const float m_new = fmaxf(m_old, mt);
      float lt = 0.0f;
      if (vh) {
        for (int rr = lr; rr < n; rr += LH) {
          const float p = expf(sh[rr] - m_new);
          lt += p;
          sh[rr] = kQuant ? p * vs : p;
        }
      }
      for (int o = LH >> 1; o > 0; o >>= 1)
        lt += __shfl_xor_sync(0xffffffffu, lt, o);
      if (vh && lr == 0) {
        const float alpha = expf(m_old - m_new);
        ha[hh] = alpha;
        hl[hh] = hl[hh] * alpha + lt;
        hm[hh] = m_new;
      }
    }
    __syncthreads();

    // ---- o = o * alpha + sum_r w_r V_r: a thread owns chunks of the V
    // row, row groups take interleaved rows ----
    if (g < G) {
#pragma unroll
      for (int kc = 0; kc < CPT; ++kc) {
        const int c = c0 + kc * kThreads;
        if (c >= NCs || (kc > 0 && !wide)) continue;
        const int hc = (cs0 + c) / NCH - h_lo;
        const float alpha = ha[hc];
#pragma unroll
        for (int i = 0; i < FPC; ++i) acc[kc][i] *= alpha;
        const float* wh = sc + hc * TR;
#pragma unroll 4
        for (int rr = g; rr < n; rr += G) {
          const float wr = wh[rr];
          unsigned wv[NU];
          load_chunk<VB, NU>(vt + rr * SB + c * VB, wv);
#pragma unroll
          for (int k = 0; k < NU; ++k) {
            float x[FU];
            decode<KIND, U>(wv[k], x);
#pragma unroll
            for (int f = 0; f < FU; ++f)
              acc[kc][k * FU + f] = fmaf(wr, x[f], acc[kc][k * FU + f]);
          }
        }
      }
    }
    __syncthreads();
#if RING_PARTIAL_SPLIT != 2
    if (pl.bulk && t + stages < n_tiles) {
      // stage s passes to tile t + stages; an owned new row goes into it
      // now, into bytes the copy leaves alone (the next barrier makes it
      // visible before that tile is read)
      if (own && t + stages == t_last) put_new_row(false, s);
      if (warp == 0) {
        const int pid = publish(t + stages);
        if (lane == 0) copy(t + stages, pid);
      }
    }
#endif
  }
  if constexpr (kSliced)
    cooperative_groups::this_cluster().sync();   // peers read our dots

#if RING_PARTIAL_SPLIT == 1
epilogue:
#endif
  // ---- the row groups' sums (in the ring, free now), o / l, m, l ----
  if (G > 1) {
    float* red = reinterpret_cast<float*>(ring);
    if (g >= 1 && g < G) {
#pragma unroll
      for (int i = 0; i < FPC; ++i)
        red[((g - 1) * NCs + c0) * FPC + i] = acc[0][i];
    }
    __syncthreads();
    if (g == 0) {
      for (int gg = 1; gg < G; ++gg) {
#pragma unroll
        for (int i = 0; i < FPC; ++i)
          acc[0][i] += red[((gg - 1) * NCs + c0) * FPC + i];
      }
    }
  }
  if (g == 0) {
#pragma unroll
    for (int kc = 0; kc < CPT; ++kc) {
      const int c = c0 + kc * kThreads;
      if (c >= NCs || (kc > 0 && !wide)) continue;
      const float l = hl[(cs0 + c) / NCH - h_lo];
      float* o = a.out + bD;
      // runs of 4 consecutive features are 16-byte aligned when a unit
      // holds 4 elements, or a float32 or bfloat16 chunk 4 units
      if constexpr (EU == 4 || (!kQuant && NU == 4)) {
#pragma unroll
        for (int i = 0; i < FPC; i += 4) {
          const int k = i / FU, f = i - k * FU;
          const int p = f / EU, e = f - p * EU;
          const float4 v = make_float4(acc[kc][i] / l, acc[kc][i + 1] / l,
                                       acc[kc][i + 2] / l, acc[kc][i + 3] / l);
          *reinterpret_cast<float4*>(
              o + feature_of<KIND, NE, EU>(cs0 + c, k, e, p, dhk)) = v;
        }
      } else {
#pragma unroll
        for (int i = 0; i < FPC; ++i) {
          const int k = i / FU, f = i - k * FU;
          const int p = f / EU, e = f - p * EU;
          o[feature_of<KIND, NE, EU>(cs0 + c, k, e, p, dhk)] = acc[kc][i] / l;
        }
      }
    }
  }
  if constexpr (MODE == kPartial) {
    // a head's m and l come from the block holding its first chunk
    for (int hh = tid; hh < Hs; hh += kThreads) {
      if ((h_lo + hh) * NCH < cs0) continue;
      a.m_out[static_cast<long long>(b) * H + h_lo + hh] = hm[hh];
      a.l_out[static_cast<long long>(b) * H + h_lo + hh] = hl[hh];
    }
  }
}

constexpr int kMaxDevices = 64;

// Launches above 48 KB of shared memory need the kernel's attribute raised,
// and clusters above 8 blocks the non-portable size allowed. Each is set
// only when a launch asks for more than this instantiation was allowed so
// far on the current device, not on every launch.
template <int KIND, int VB, int MODE, class Pages, bool kSliced>
cudaError_t run_kernel(const Args& a, const Plan& pl, int B,
                       cudaStream_t stream) {
  auto kernel = attention_kernel<KIND, VB, MODE, Pages, kSliced>;
  if (pl.smem > 48 * 1024 || pl.slices > 8) {
    static std::mutex mu;
    static int allowed[kMaxDevices] = {};
    static bool wide[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mu);
    const bool known = dev < kMaxDevices;
    if (pl.smem > 48 * 1024 && (!known || pl.smem > allowed[dev])) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
      if (err != cudaSuccess) return err;
      if (known) allowed[dev] = pl.smem;
    }
    if (pl.slices > 8 && (!known || !wide[dev])) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      if (known) wide[dev] = true;
    }
  }
  if constexpr (!kSliced) {
    kernel<<<B, kThreads, pl.smem, stream>>>(a, pl);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * pl.slices);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, pl);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int KIND, int VB, int MODE, class Pages>
cudaError_t run(const Args& a, const Plan& pl, int B, cudaStream_t stream) {
  return pl.slices > 1
             ? run_kernel<KIND, VB, MODE, Pages, true>(a, pl, B, stream)
             : run_kernel<KIND, VB, MODE, Pages, false>(a, pl, B, stream);
}

// Plan and launch one call over B slots; kind as PoolKind (kWithInt4:
// whether packed int4 pools are taken). Returns the cudaError_t of the
// launch (0 = launched).
template <class Pages, int MODE, bool kWithInt4>
int launch(int kind, const Args& a, int B, int D, int NP, int P, int W,
           int H, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (kind == kI4 && !kWithInt4) return cudaErrorInvalidValue;
  if ((kind == kI8 || kind == kI4) &&
      (a.k_scales == nullptr || a.v_scales == nullptr))
    return cudaErrorInvalidValue;
  if (MODE == kPartial && (a.ring_start == nullptr || a.m_out == nullptr ||
                           a.l_out == nullptr))
    return cudaErrorInvalidValue;
  if (MODE == kFusedWrite && (a.k_new == nullptr || a.v_new == nullptr))
    return cudaErrorInvalidValue;
  Plan pl;
  const bool aligned = reinterpret_cast<uintptr_t>(a.pool) % 16 == 0;
  if (!make_plan(pl, kind, D, H, P, W, NP, aligned))
    return cudaErrorInvalidValue;
  switch (kind * 100 + pl.vb) {
    case kF32 * 100 + 16: return run<kF32, 16, MODE, Pages>(a, pl, B, stream);
    case kF32 * 100 + 4: return run<kF32, 4, MODE, Pages>(a, pl, B, stream);
    case kI8 * 100 + 16: return run<kI8, 16, MODE, Pages>(a, pl, B, stream);
    case kI8 * 100 + 4: return run<kI8, 4, MODE, Pages>(a, pl, B, stream);
    case kI8 * 100 + 1: return run<kI8, 1, MODE, Pages>(a, pl, B, stream);
    case kBF16 * 100 + 16: return run<kBF16, 16, MODE, Pages>(a, pl, B, stream);
    case kBF16 * 100 + 4: return run<kBF16, 4, MODE, Pages>(a, pl, B, stream);
    case kBF16 * 100 + 2: return run<kBF16, 2, MODE, Pages>(a, pl, B, stream);
    default: break;
  }
  if constexpr (kWithInt4) {
    switch (pl.vb) {
      case 16: return run<kI4, 16, MODE, Pages>(a, pl, B, stream);
      case 4: return run<kI4, 4, MODE, Pages>(a, pl, B, stream);
      case 1: return run<kI4, 1, MODE, Pages>(a, pl, B, stream);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

// Shared memory bytes of a launch whose pool is 16-byte aligned; -1 when
// the kernel does not take the shapes.
inline long long smem_bytes(int kind, int D, int H, int P) {
  Plan pl;
  return make_plan(pl, kind, D, H, P, 1, 1, true) ? pl.smem : -1;
}

}  // namespace
}  // namespace ring_partial
