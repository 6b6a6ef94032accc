// Masked multi-head attention backward for Hopper (sm_90a) in fp32 (FMAs, no
// TF32) on register micro-tiles, with thread-block clusters that split Dh
// where one block cannot hold the head: the kernel template and its C entry
// point. Each source defines MMU_BWD_PLAIN_DIMS (and MMU_BWD_DROPOUT_DIMS)
// before including this header, so the instances compile in separate nvcc
// processes, started together (ops/_build.py), and each library holds the
// head dims it names:
//   * attention_bwd.cu       Dh 32, 64, 128, and the dropout instances at Dh
//                            32 and 64;
//   * attention_bwd_k6.cu    Dh 24, 48, 96, 192;
//   * attention_bwd_256.cu   Dh 256 (FLAVA fusion's default 3 heads);
//   * attention_bwd_wide.cu  Dh 384, 768 (clusters of 2 and 4 blocks).
// Every bf16 launch runs on the tensor cores instead, attention_bwd_tc.cuh
// and attention_bwd_tc_wide.cuh (ops/attention.py::bwd_source never routes
// one here).
//
// Replaces these Pallas TPU kernels of multimodal_uncertainty_tpu/ops/attention.py:
//   * _sdpa_packed_bwd_impl :813 (body _attn_bwd_kernel_hl :443): the
//     whole-sequence backward that writes dQ | dK | dV into the packed
//     (B, S, 3D) layout of the QKV projection's gradient (K1: FLAVA fusion,
//     ViLT);
//   * _sdpa_flash_bwd_impl :1219 (bodies _attn_kernel_flash_dq :1105 and
//     _attn_kernel_flash_dkv :1151, delta from _flash_delta): the blocked
//     backward that rebuilds P from the forward's log-sum-exp (K3);
//   * _sdpa_hl_bwd_impl :504: the same on BERT's separate heads-last q, k, v
//     (K2: Dh 64; Dh 32 for the tiny config);
//   * _sdpa_pallas_hl_drop_bwd :717 (body _attn_bwd_kernel_hl_drop): the
//     backward chained through dropout on the attention probabilities, from
//     the uint8 (B, H, S, S) keep mask the forward used (K5, the DROPOUT
//     instances);
//   * _sdpa_bwd_impl :253 (body _attn_bwd_kernel :198): the heads-first
//     backward of the custom VJP _sdpa_pallas, which the TPU takes at Dh 24,
//     48, 96 and 192 (K6). It recomputes the softmax where this backward
//     reads the forward's lse; the products are the same;
//   * _sdpa_flash_bwd_stream_impl :1521 (bodies :1374 and :1421): the
//     long-context backward (K4 in fp32, reached through attention_flash).
// The TPU needed several because the whole-sequence score plane stops
// fitting VMEM past S ~ 574 at fp32; here one kernel streams tiles from
// device memory at any S (64-bit offsets).
//
// Function and contract. Three launches: delta = rowsum(dO * O) per (row,
// head); a dQ pass over query blocks looping over key tiles; a dK/dV pass
// over key blocks looping over query tiles:
//   P = exp(q k^T * scale + bias - lse), dP = dO v^T, dS = P * (dP - delta),
//   dQ = dS k * scale, dK = dS^T q * scale, dV = P^T dO.
// Each block owns its output rows and columns: no atomics, the result is
// deterministic. No (S, S) plane goes to device memory. Masked keys take the
// finite -1e30 after the scaled product, keys past S weigh exactly 0, and a
// query row with lse <= -5e29 (all its keys masked; its lse is -1e30 in
// fp32, where s - lse would round to 0 and give P = 1) takes P = 1/S, the
// gradient of the forward's uniform average, as K1, K6 and XLA give (the
// TPU flash kernel K3 writes zeros there; that is not copied). Every product
// sums in fp32.
// Dropout (DROPOUT, Dh 32 and 64): the forward computed O = Pd V with Pd =
// P keep inv_keep, inv_keep = 1 / (1 - rate), so dV = Pd^T dO,
// dP = keep inv_keep (dO V^T), dS = P (dP - delta), and dQ, dK as above.
// delta needs no change: rowsum(dO * O) = sum_k P_k keep_k inv_keep (dO .
// v_k) = sum_k P_k dP_k, JAX's sum(dp * p). The keep byte of (query, key) is
// (own row, key) in the dQ pass and (query, own row) in the dK/dV pass; each
// thread loads its tile's bytes before the scores, which hide their latency.
// q, k, v are read through base pointers with one row stride, dq, dk, dv
// written with their own (the packed projection and its gradient in place);
// out and dout dense (B, S, D); lse and delta (B, H, S) fp32.
//
// What bounds the work: the fp32 FMA units. The two passes execute 14 B S^2 D
// flops (S and dP are recomputed in both, so that each block keeps its
// outputs in registers): 141 GFLOP at B=128, S=320, D=768, 2.1 ms at 67
// TFLOP/s. The bytes (~8 B S D itemsize, and the B H S^2 keep bytes with
// dropout) are a hundredth of that.
// Measured on an H100 80GB HBM3 at 700 W (tools/bench_attention.py, that
// shape, fp32): 7.05 / 6.16 / 6.02 / 5.25 / 4.87 / 4.65 / 4.37 / 5.04 /
// 4.74 / 5.38 ms at Dh 24 / 32 / 48 / 64 / 96 / 128 / 192 / 256 / 384 /
// 768, 30-48 % of the fp32 rate (the SIMT kernel this replaced at Dh 24-192
// took 6.2-9.3 ms); K4 in fp32 (B=1, S=16384, 12 x 64) 102 ms. The small
// head dims pay for the per-tile work that does not scale with Dh (P and
// dS, three barriers, the streamed tile's row info) and for a few spilled
// registers under MINB = 2. At Dh 256, with parts removed one at a time:
// the scores (S and dP in both passes) ~2.2 ms, at ~55 % of the FMA rate;
// the products ~1.6 ms, ~57 %; P and dS ~0.3 ms; the rest (prologue loads,
// barriers, epilogue) ~1.3 ms.
//
// Design. An instance is (N, C, R): a cluster of N blocks owns R rows
// (queries in the dQ pass, keys in the dK/dV pass), each block a C-column
// slice of Dh = N C; N = 1 up to Dh 256, where the cluster path compiles out
// and both rendezvous are __syncthreads. The 256 KB register file of an SM
// holds the dK and dV accumulators of 2 R C fp32 values, R C / 128 a thread
// (Wide<DH> below, WideDropout<DH> for the dropout instances, with the
// product map GC and the blocks an SM the compiler must allow, MINB).
// A block:
//   * keeps its slice of the own rows' two operands (q and dO, or k and v) in
//     shared memory, its slice of dQ, or of dK and dV, in registers;
//   * streams the other operands (k and v, or q and dO) in 32-row tiles of
//     its slice through a two-stage cp.async ring: the next tile's loads are
//     issued once the block is past the
//     previous tile's products, and overlap this tile's P, dS and products;
//   * for each tile computes the partial S and dP (R x 32 each) over its
//     slice and publishes it in its shared memory; after a barrier.cluster,
//     each block sums 1/N of the positions over the N blocks (distributed
//     shared memory, in rank order), forms their P and dS and writes them,
//     rounded, into every block's P / dS tile; a second barrier and the
//     products go on locally. Nothing is recomputed, nothing goes through
//     device memory.
// Every product accumulates in per-thread register micro-tiles, so that each
// 16-byte load (mostly broadcast within a quarter warp) feeds several FMAs:
//   * scores: 4 x R/8 (rows x tile rows) a thread; the Dh reduction is split
//     between two warp pairs, whose partial tiles are summed through shared
//     memory before the cluster's sum;
//   * products: kPI x kPJ (rows x 16-byte chunks) a thread, 128 threads a
//     group as 128 / GC row groups x GC chunk groups (C = 24: 64 x 2, 48:
//     32 x 4, 32 and 96: 16 x 8, else 8 x 16): dK and dV on the two groups,
//     or dQ with the tile's rows split between them and summed at the end.
// In every load the 8 threads of a quarter warp hit distinct banks or the
// same word (at: the 16-byte chunk c of row r sits at c ^ (r % 8), or rows
// padded by one chunk where C is no multiple of 32).
// Shared memory: 2 R C own rows + 2 x 2 x 32 C stream ring + 2 x 2 x R x 32
// partials and P / dS (the
// latter first the second half's partial scores) + 1 KB row info, in fp32
// words (C padded where it is no multiple of 32): 225 KB at (C, R) = (192,
// 64), 209 KB at (256, 32), 129 KB at (96, 64), 113 KB at (128, 32), 97 KB
// at (64, 64), under 90 KB below. MINB = 2 caps a thread at 128 registers.
// Each shape was chosen by timing the candidates in one call (the same card
// and tool, B=128, S=320, fp32, and MMBT's B=32, S=165 at Dh=64): at Dh 24,
// 32, 48 R = 64 with MINB = 2 (7.05 / 6.16 / 6.02 ms) beats MINB = 1 (9.26 /
// 7.45 / 6.97; 32 and 48 at R = 32: 7.03 / 7.89); at Dh 64 R = 32 (5.25,
// 0.533 at MMBT's shape) beats R = 64 (5.32-5.37, 0.543-0.550); at Dh 96
// and 192 R = 64 (4.88 / 4.36) beats R = 32 with two blocks an SM (5.38 /
// 5.05); at Dh 128 the two are within 1 % (4.62-4.68). The dropout
// instances keep R = 64 without the register cap (WideDropout): at Dh=64,
// MMBT's shape, 0.587-0.591 ms against 0.649-0.654 capped (128-180 bytes
// of spills) and 0.727 at R = 32.
// Left for later: the next tile's scores during the second barrier, split
// fp32 on wgmma (as the forward's attention_fwd_tc32.cuh), a persistent grid,
// one pass with dQ by atomics.
#pragma once
#include <type_traits>

#include "attention_cluster.cuh"

// The head dims a library holds dropout instances of (empty by default): see
// the C entry point.
#ifndef MMU_BWD_DROPOUT_DIMS
#define MMU_BWD_DROPOUT_DIMS
#endif

namespace {

// The instance of one head dim: N blocks a cluster, C columns a block, R rows;
// GC chunk groups of the product micro-tiles (128 / GC row groups); MINB
// blocks an SM (2 caps a thread at 128 registers).
template <int DH>
struct Wide;
template <>
struct Wide<24> {
  static constexpr int N = 1, C = 24, R = 64, GC = 2, MINB = 2;
};
template <>
struct Wide<32> {
  static constexpr int N = 1, C = 32, R = 64, GC = 8, MINB = 2;
};
template <>
struct Wide<48> {
  static constexpr int N = 1, C = 48, R = 64, GC = 4, MINB = 2;
};
template <>
struct Wide<64> {
  static constexpr int N = 1, C = 64, R = 32, GC = 16, MINB = 1;
};
template <>
struct Wide<96> {
  static constexpr int N = 1, C = 96, R = 64, GC = 8, MINB = 1;
};
template <>
struct Wide<128> {
  static constexpr int N = 1, C = 128, R = 32, GC = 16, MINB = 2;
};
template <>
struct Wide<192> {
  static constexpr int N = 1, C = 192, R = 64, GC = 16, MINB = 1;
};
template <>
struct Wide<256> {  // attention_bwd_256.cu says why this shape
  static constexpr int N = 1, C = 256, R = 32, GC = 16, MINB = 1;
};
template <>
struct Wide<384> {
  static constexpr int N = 2, C = 192, R = 64, GC = 16, MINB = 1;
};
template <>
struct Wide<768> {
  static constexpr int N = 4, C = 192, R = 64, GC = 16, MINB = 1;
};

// The dropout instances' shapes (BERT's head dims): the keep bytes take
// registers, which a cap of 128 a thread would spill.
template <int DH>
struct WideDropout;
template <>
struct WideDropout<32> {
  static constexpr int N = 1, C = 32, R = 64, GC = 8, MINB = 1;
};
template <>
struct WideDropout<64> {
  static constexpr int N = 1, C = 64, R = 64, GC = 16, MINB = 1;
};

template <int DH, bool DROPOUT>
using Pick = std::conditional_t<DROPOUT, WideDropout<DH>, Wide<DH>>;

template <int N, int C, int R, int GC>
struct Shape {
  static_assert(C % 8 == 0 && (R == 32 || R == 64) && (R * kT / 4) % N == 0, "no such shape");
  static constexpr int kChunks = C / 4;           // 16-byte fp32 chunks of a slice row
  static constexpr int kLd = pitch<C>();          // floats a slice row takes in shared memory
  static constexpr int kOwnFloats = 2 * R * kLd;  // two operands
  static constexpr int kTileFloats = 2 * kT * kLd;  // two operands of one streamed tile
  static constexpr int kPartFloats = 2 * R * kT;  // the block's partial S' and dP'
  static constexpr int kPdsFloats = 2 * R * kT;   // P and dS, swizzled rows of kT floats
  static constexpr int kSlots = R * kT / 4;       // float4 slots of each partial
  static constexpr int kShare = kSlots / N;       // the slots whose P and dS a block forms
  static constexpr int kSlotIters = (kShare + kThreads - 1) / kThreads;
  // scores: 4 rows (rg + kRG i) x kMJ tile rows (tg + kTG j) a thread, 64
  // threads a matrix and half of the slice
  static constexpr int kMJ = R / 8;
  static constexpr int kRG = R / 4;
  static constexpr int kTG = kT / kMJ;
  static constexpr int kK = kMJ;  // float4 slots a thread publishes
  // products: kPI rows (prg + kGR i) x kPJ chunks (pcg + GC j) a thread, 128
  // threads (kGR x GC) a group
  static constexpr int kGR = 128 / GC;
  static constexpr int kPI = R / kGR;
  static constexpr int kPJ = kChunks / GC;
  static_assert(GC > 0 && 128 % GC == 0 && R % kGR == 0 && kChunks % GC == 0,
                "the product micro-tiles must tile R x C");
  // the ring: two stages of fp32 tiles
  static constexpr int kBytes =
      (kOwnFloats + 2 * kTileFloats + kPartFloats + kPdsFloats) * 4 + 2 * kT * 16;
  static_assert(R * C <= 2 * kTileFloats, "dQ's second half is summed in the stream area");
};

// x[i][j] += sum over chunks [c0, c0 + C / 8) of a[rg + kRG i] . b[tg + kTG j]
// (swizzled tiles of C-float rows).
template <int C, int R>
__device__ __forceinline__ void partial_scores(const float* a, const float* b, int rg, int tg,
                                               int c0, float (&x)[4][R / 8]) {
  constexpr int kMJ = R / 8, kRG = R / 4, kTG = kT / kMJ;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMJ; ++j) x[i][j] = 0.f;
#pragma unroll 4
  for (int c = c0; c < c0 + C / 8; ++c) {
    float4 bj[kMJ];
#pragma unroll
    for (int j = 0; j < kMJ; ++j) bj[j] = ld4(b + at<C>(tg + kTG * j, c));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 ai = ld4(a + at<C>(rg + kRG * i, c));
#pragma unroll
      for (int j = 0; j < kMJ; ++j) x[i][j] = dot4(ai, bj[j], x[i][j]);
    }
  }
}

// P of one (query, key) pair from the forward's log-sum-exp. Keys past S do
// not exist; a fully masked query row is the forward's uniform average.
__device__ __forceinline__ float prob(float score, float bias, float lse, bool exists,
                                      float inv_s) {
  if (!exists) return 0.f;
  if (lse <= 0.5f * kMaskBias) return inv_s;
  return expf(score + bias - lse);
}

// Pass 1: delta = rowsum(dO * O) per (row, head); one warp a row.
__global__ void __launch_bounds__(kThreads)
attention_bwd_wide_delta_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                                float* __restrict__ delta, int B, int S, int H, int DH) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kWarps + warp;  // b * S + s
  if (row >= (long long)B * S) return;
  const int b = (int)(row / S);
  const int s = (int)(row % S);
  const int D = H * DH;
  const float* o = out + row * D;
  const float* g = dout + row * D;
  for (int h = 0; h < H; ++h) {
    float acc = 0.f;
    for (int c = lane; c < DH; c += 32) {
      acc = fmaf(o[h * DH + c], g[h * DH + c], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) delta[((long long)b * H + h) * S + s] = acc;
  }
}

// Passes 2 and 3. DKV false: the dQ pass, own rows = queries (A0 = q, A1 =
// dO), streamed rows = keys (B0 = k, B1 = v), dQ += dS k. DKV true: the dK/dV
// pass, own rows = keys (A0 = k, A1 = v), streamed = queries (B0 = q, B1 =
// dO), dK += dS^T q, dV += Pd^T dO. Either way the scores of the pass are
// S' = A0 B0^T and dP' = A1 B1^T over Dh (the transposes in the dK/dV pass).
//
// The block's 8 warps take three roles a tile:
//   * scores: warps 0-3 S', warps 4-7 dP'; warp pairs (0, 1) and (2, 3) sum
//     the slice's first and second halves of columns: 64 threads cover the
//     R x 32 tile in 4 x R/8 micro-tiles, rows rg + R/4 i, tile rows tg +
//     32/(R/8) j. The second half's partials go through shared memory to the
//     first, which publishes the block's partial to the cluster;
//   * P and dS: the block's 1/N share of the R 8 float4 slots of each
//     partial, kSlotIters a thread; a thread sums 4 positions over the
//     cluster and forms and writes their P and dS (DROPOUT: dP takes keep *
//     inv_keep, and the P of dV = Pd^T dO is Pd = P keep inv_keep);
//   * products: two groups of 128 threads, each kPI rows x kPJ chunks a
//     thread (rows prg + kGR i, the slice's chunks pcg + GC j). dK/dV pass:
//     group 0 dK += dS^T q, group 1 dV += Pd^T dO over the whole tile. dQ
//     pass: both dQ += dS k, group 0 over the tile's first 16 rows, group 1
//     over the other 16; the two partial dQs are summed once, at the end.
template <int DH, bool DKV, bool DROPOUT>
__global__ void __launch_bounds__(kThreads, (Pick<DH, DROPOUT>::MINB))
attention_bwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, long long row_stride,
                          const uint8_t* __restrict__ mask, const uint8_t* __restrict__ keep,
                          float inv_keep, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ d0, float* __restrict__ d1, long long grad_stride,
                          int S, int H, float scale) {
  using Inst = Pick<DH, DROPOUT>;
  constexpr int N = Inst::N, C = Inst::C, R = Inst::R, GC = Inst::GC;
  using Sh = Shape<N, C, R, GC>;
  constexpr int kLd = Sh::kLd;
  constexpr int kMJ = Sh::kMJ, kRG = Sh::kRG, kTG = Sh::kTG, kK = Sh::kK;
  constexpr int kPI = Sh::kPI, kPJ = Sh::kPJ, kGR = Sh::kGR;
  constexpr int kShare = Sh::kShare, kSlotIters = Sh::kSlotIters;
  extern __shared__ __align__(128) float smem[];
  float* own = smem;                               // [2][R][kLd]: A0, A1
  float* stream = own + Sh::kOwnFloats;            // [2 stages][2][kT][kLd]
  float4* part = reinterpret_cast<float4*>(stream + 2 * Sh::kTileFloats);  // [2][kK][64]: S', dP'
  float* pds = stream + 2 * Sh::kTileFloats + Sh::kPartFloats;  // [2][R][kT]: P, dS
  float4* rinfo = reinterpret_cast<float4*>(pds + Sh::kPdsFloats);  // [2 stages][kT]

  int rank = 0, r0 = blockIdx.x * R;
  if constexpr (N > 1) {
    rank = (int)cluster_rank();
    r0 = (int)cluster_id() * R;
  }
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = H * DH;
  const long long col = (long long)h * DH + rank * C;  // this block's slice of the head
  const long long qkv_off = (long long)b * S * row_stride + col;
  const long long dout_off = (long long)b * S * D + col;
  const long long stat_off = ((long long)b * H + h) * S;
  const uint8_t* key_mask = mask ? mask + (long long)b * S : nullptr;
  const float inv_s = 1.f / (float)S;

  const float* a0 = DKV ? k + qkv_off : q + qkv_off;
  const float* a1 = DKV ? v + qkv_off : dout + dout_off;
  const long long a1_stride = DKV ? row_stride : D;
  const float* b0 = DKV ? q + qkv_off : k + qkv_off;
  const float* b1 = DKV ? dout + dout_off : v + qkv_off;
  const long long b1_stride = DKV ? D : row_stride;

  // Streamed tile t0 into stage `stage`, with its rows' info: keys (dQ pass)
  // .x = exponent bias, .y = exists; queries (dK/dV pass) .x = lse, .y =
  // delta, .z = exists.
  auto prefetch = [&](int stage, int t0) {
    float* st = stream + stage * Sh::kTileFloats;
    load_rows<kT, C>(st, b0, row_stride, t0, S);
    load_rows<kT, C>(st + kT * kLd, b1, b1_stride, t0, S);
    if (tid < kT) {
      const int s = t0 + tid;
      float4 info = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s < S) {
        if constexpr (DKV)
          info = make_float4(lse[stat_off + s], delta[stat_off + s], 1.f, 0.f);
        else
          info = make_float4(key_mask && !key_mask[s] ? kMaskBias : 0.f, 1.f, 0.f, 0.f);
      }
      rinfo[stage * kT + tid] = info;
    }
    cp_async_commit();
  };

  load_rows<R, C>(own, a0, row_stride, r0, S);
  load_rows<R, C>(own + R * kLd, a1, a1_stride, r0, S);
  prefetch(0, 0);

  // score roles: matrix sm (0: S', 1: dP'), half hf of the slice's chunks
  const int sm = warp / 4, hf = (warp / 2) % 2, i64 = (warp % 2) * 32 + lane;
  const int rg = i64 / kTG, tg = i64 % kTG;
  // P / dS roles: slot u of this thread (tid + kThreads u < kShare) is the
  // partials' float4 slot pkk, pi64 (of kSlots for each matrix) in this
  // block's share, i.e. row prow and tile rows pt0 + kTG e, e < 4; its row's
  // info: dQ pass (a query) lse, delta, exists; dK/dV pass (a key) exponent
  // bias, exists
  int prow[kSlotIters], pt0[kSlotIters], pslot[kSlotIters];
  float own_x[kSlotIters], own_y[kSlotIters];
  bool own_in[kSlotIters];
#pragma unroll
  for (int u = 0; u < kSlotIters; ++u) {
    const int slot = rank * kShare + min(tid + kThreads * u, kShare - 1);
    const int pkk = slot / 64, pi64 = slot % 64;
    pslot[u] = pkk * 64 + pi64;
    prow[u] = pi64 / kTG + kRG * (pkk / (kMJ / 4));
    pt0[u] = pi64 % kTG + kTG * 4 * (pkk % (kMJ / 4));
    const int s = r0 + prow[u];
    own_in[u] = s < S;
    if constexpr (DKV) {
      own_x[u] = s < S && key_mask && !key_mask[s] ? kMaskBias : 0.f;
      own_y[u] = 0.f;
    } else {
      own_x[u] = s < S ? lse[stat_off + s] : 0.f;
      own_y[u] = s < S ? delta[stat_off + s] : 0.f;
    }
  }
  // product roles: group pg, rows prg + kGR i (i < kPI), chunks pcg + GC j (j < kPJ)
  const int pg = warp / 4, prg = (tid % 128) / GC, pcg = tid % GC;

  float4 acc[kPI][kPJ];
#pragma unroll
  for (int i = 0; i < kPI; ++i)
#pragma unroll
    for (int j = 0; j < kPJ; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  const float* A = own + sm * R * kLd;
  float* P = pds;
  float* dS = pds + R * kT;
  float4* scratch = reinterpret_cast<float4*>(pds);  // the second half's partials
  const float* W = DKV && pg ? P : dS;                // the product's left operand
  const int c4_lo = DKV ? 0 : 4 * pg, c4_hi = DKV ? kT / 4 : 4 * pg + 4;
  const uint32_t part_addr = smem_u32(part), pds_addr = smem_u32(pds);
  const int n_tiles = (S + kT - 1) / kT;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile it (and, at it = 0, the own rows) is in; tile it - 1 is consumed
    const float* B0 = stream + stage * Sh::kTileFloats;
    const float4* info = rinfo + stage * kT;
    // DROPOUT: this thread's keep bytes of the tile, loaded before the scores so that their
    // latency hides behind them; (query, key) = (own row, t0 + t) or (t0 + t, own row)
    uint8_t kept[kSlotIters][4];
    if constexpr (DROPOUT) {
#pragma unroll
      for (int u = 0; u < kSlotIters; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = it * kT + pt0[u] + kTG * e, own_s = r0 + prow[u];
          const long long idx = DKV ? (stat_off + s) * S + own_s : (stat_off + own_s) * S + s;
          kept[u][e] = s < S && own_in[u] ? keep[idx] : 0;
        }
    }

    // this thread's partial of S' or dP' over its half of the slice
    float x[4][kMJ];
    partial_scores<C, R>(A, B0 + sm * kT * kLd, rg, tg, hf * (Sh::kChunks / 2), x);
    if (hf) {
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        const int i = kk / (kMJ / 4), j = 4 * (kk % (kMJ / 4));
        scratch[(sm * kK + kk) * 64 + i64] =
            make_float4(x[i][j], x[i][j + 1], x[i][j + 2], x[i][j + 3]);
      }
    }
    __syncthreads();
    // the cluster's sums, reduce-scatter then all-gather: each block sums
    // 1/N of the positions over the cluster (in rank order) and writes their
    // P and dS into every block
    if (!hf) {
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        const int i = kk / (kMJ / 4), j = 4 * (kk % (kMJ / 4));
        part[(sm * kK + kk) * 64 + i64] =
            add4(make_float4(x[i][j], x[i][j + 1], x[i][j + 2], x[i][j + 3]),
                 scratch[(sm * kK + kk) * 64 + i64]);
      }
    }
    rendezvous<N>();  // every block's partials are published; remote blocks may write P and dS
    // every thread of the block is past tile it - 1's products: its stage is free
    if (it + 1 < n_tiles) prefetch(stage ^ 1, (it + 1) * kT);
#pragma unroll
    for (int u = 0; u < kSlotIters; ++u) {
      if (kShare % kThreads != 0 && tid + kThreads * u >= kShare) break;
      float4 ss, dd;
      if constexpr (N == 1) {
        ss = part[pslot[u]];
        dd = part[kK * 64 + pslot[u]];
      } else {
        ss = make_float4(0.f, 0.f, 0.f, 0.f), dd = ss;
#pragma unroll
        for (int r = 0; r < N; ++r) {
          ss = add4(ss, ld_cluster4(part_addr + 16 * pslot[u], r));
          dd = add4(dd, ld_cluster4(part_addr + 16 * (kK * 64 + pslot[u]), r));
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = pt0[u] + kTG * e;
        const float4 ti = info[t];
        float p, dlt;
        if constexpr (DKV) {  // prow: key, t: query
          p = prob(comp(ss, e) * scale, own_x[u], ti.x, ti.z != 0.f && own_in[u], inv_s);
          dlt = ti.y;
        } else {  // prow: query, t: key
          p = prob(comp(ss, e) * scale, ti.x, own_x[u], ti.y != 0.f, inv_s);
          dlt = own_y[u];
        }
        float dp = comp(dd, e), pd = p;
        if constexpr (DROPOUT) {
          dp = kept[u][e] ? dp * inv_keep : 0.f;
          pd = kept[u][e] ? p * inv_keep : 0.f;
        }
        const int o = at<kT>(prow[u], t / 4) + t % 4;
        const float ds = p * (dp - dlt);
        const float pr = pd;
        if constexpr (N == 1) {
          dS[o] = ds;
          if constexpr (DKV) P[o] = pr;
        } else {
#pragma unroll
          for (int r = 0; r < N; ++r) {
            st_cluster(pds_addr + 4 * (o + R * kT), r, ds);
            if constexpr (DKV) st_cluster(pds_addr + 4 * o, r, pr);
          }
        }
      }
    }
    rendezvous<N>();  // every block's P and dS are written, its partials read

    // dQ += dS k (group pg: tile rows 16 pg ..), or dK += dS^T q (group 0) and
    // dV += Pd^T dO (group 1)
    const float* Bp = B0 + (DKV && pg ? kT * kLd : 0);
#pragma unroll 4
    for (int c4 = c4_lo; c4 < c4_hi; ++c4) {
      float4 w4[kPI];
#pragma unroll
      for (int i = 0; i < kPI; ++i) w4[i] = ld4(W + at<kT>(prg + kGR * i, c4));
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const int t = 4 * c4 + tt;
        float4 y[kPJ];
#pragma unroll
        for (int j = 0; j < kPJ; ++j) y[j] = ld4(Bp + at<C>(t, pcg + GC * j));
#pragma unroll
        for (int i = 0; i < kPI; ++i)
#pragma unroll
          for (int j = 0; j < kPJ; ++j) fma4(acc[i][j], comp(w4[i], tt), y[j]);
      }
    }
  }
  // no block reads or writes this one's shared memory after the last barrier

  const long long out_off = (long long)b * S * grad_stride + col;
  float* dst = d0;
  float mul = scale;
  if constexpr (DKV) {  // group 0: dK (scaled) into d0; group 1: dV into d1
    if (pg) {
      dst = d1;
      mul = 1.f;
    }
  } else {  // dQ: group 1's half of the tile rows joins group 0's through shared memory
    float4* half = reinterpret_cast<float4*>(stream);  // [kPI][kPJ][128]
    __syncthreads();  // the stream area is consumed
    if (pg) {
#pragma unroll
      for (int i = 0; i < kPI; ++i)
#pragma unroll
        for (int j = 0; j < kPJ; ++j) half[(i * kPJ + j) * 128 + tid % 128] = acc[i][j];
    }
    __syncthreads();
    if (pg) return;
#pragma unroll
    for (int i = 0; i < kPI; ++i)
#pragma unroll
      for (int j = 0; j < kPJ; ++j) acc[i][j] = add4(acc[i][j], half[(i * kPJ + j) * 128 + tid]);
  }
#pragma unroll
  for (int i = 0; i < kPI; ++i) {
    const int s = r0 + prg + kGR * i;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < kPJ; ++j) {
      const long long o = out_off + (long long)s * grad_stride + 4 * (pcg + GC * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[o + e] = comp(acc[i][j], e) * mul;
    }
  }
}

template <int DH, bool DROPOUT>
cudaError_t launch(const void* q, const void* k, const void* v, long long row_stride,
                   const void* mask, const void* keep, float inv_keep, const void* out,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, long long grad_stride, int B, int S, int H, cudaStream_t stream) {
  using W = Pick<DH, DROPOUT>;
  static_assert(W::N * W::C == DH, "a cluster's slices make the head");
  constexpr int smem = Shape<W::N, W::C, W::R, W::GC>::kBytes;
  static_assert(smem <= 227 * 1024 && W::MINB * (smem + 1024) <= 228 * 1024,
                "MINB blocks of this shape fit an SM's shared memory");
  const float scale = (float)(1.0 / sqrt((double)DH));  // rounded once, as 1.0 / dh**0.5 is
  const float* q_t = static_cast<const float*>(q);
  const float* k_t = static_cast<const float*>(k);
  const float* v_t = static_cast<const float*>(v);
  const float* dout_t = static_cast<const float*>(dout);
  const uint8_t* mask_t = static_cast<const uint8_t*>(mask);
  const uint8_t* keep_t = static_cast<const uint8_t*>(keep);

  const long long rows = (long long)B * S;
  attention_bwd_wide_delta_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0,
                                    stream>>>(static_cast<const float*>(out), dout_t, delta, B, S,
                                              H, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid(((S + W::R - 1) / W::R) * W::N, H, B);
  err = launch_clusters<W::N>(attention_bwd_wide_kernel<DH, false, DROPOUT>, grid, kThreads,
                              smem, stream, q_t, k_t, v_t, row_stride, mask_t, keep_t, inv_keep, dout_t,
                              lse, delta, static_cast<float*>(dq), static_cast<float*>(nullptr),
                              grad_stride, S, H, scale);
  if (err != cudaSuccess) return err;
  return launch_clusters<W::N>(attention_bwd_wide_kernel<DH, true, DROPOUT>, grid, kThreads,
                               smem, stream, q_t, k_t, v_t, row_stride, mask_t, keep_t, inv_keep,
                               dout_t, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
                               grad_stride, S, H, scale);
}

// The launches of the instance whose head dim is dh, among DHS; an invalid
// value when this library has none.
template <bool DROPOUT, int... DHS>
cudaError_t dispatch(Dims<DHS...>, int dh, const void* q, const void* k, const void* v,
                     long long row_stride, const void* mask, const void* keep, float inv_keep,
                     const void* out, const void* dout, const float* lse, float* delta,
                     void* dq, void* dk, void* dv, long long grad_stride, int B, int S, int H,
                     cudaStream_t stream) {
  if (row_stride % 4) return cudaErrorInvalidValue;  // 16-byte rows
  cudaError_t err = cudaErrorInvalidValue;
  (void)((dh == DHS &&
          ((err = launch<DHS, DROPOUT>(q, k, v, row_stride, mask, keep, inv_keep, out, dout,
                                       lse, delta, dq, dk, dv, grad_stride, B, S, H, stream)),
           true)) ||
         ...);
  return err;
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32 (the only one:
// every bf16 launch runs on the tensor cores, attention_bwd_tc*.cuh); dh: one
// of MMU_BWD_PLAIN_DIMS, or of MMU_BWD_DROPOUT_DIMS with keep. q, k, v:
// (B, S, D) views with row stride row_stride (whole 16-byte words, 16-byte
// aligned bases); mask: (B, S) bytes, nonzero = key kept, or NULL; keep: the
// forward's (B, H, S, S) dropout bytes with its inv_keep, or NULL for no
// dropout; out, dout: dense (B, S, D); lse: (B, H, S) float32 from the
// forward; delta: (B, H, S) float32 scratch; dq, dk, dv: (B, S, D) views
// with row stride grad_stride. Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for anything this library has no instance of).
extern "C" int mmu_attention_bwd(const void* q, const void* k, const void* v,
                                 long long row_stride, const void* mask, const void* keep,
                                 float inv_keep, const void* out, const void* dout,
                                 const void* lse, void* delta, void* dq, void* dk, void* dv,
                                 long long grad_stride, int B, int S, int H, int dh, int dtype,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || S < 1 || H < 1 || dtype != 0) return (int)cudaErrorInvalidValue;
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (keep != nullptr)
    return (int)dispatch<true>(Dims<MMU_BWD_DROPOUT_DIMS>(), dh, q, k, v, row_stride, mask, keep,
                               inv_keep, out, dout, lse_f, delta_f, dq, dk, dv, grad_stride, B,
                               S, H, st);
  return (int)dispatch<false>(Dims<MMU_BWD_PLAIN_DIMS>(), dh, q, k, v, row_stride, mask, nullptr,
                              1.f, out, dout, lse_f, delta_f, dq, dk, dv, grad_stride, B, S, H,
                              st);
}
