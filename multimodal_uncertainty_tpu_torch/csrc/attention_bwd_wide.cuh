// Masked attention backward for Hopper (sm_90a) in fp32 and bf16 (fp32
// FMAs, no TF32) on register micro-tiles, with thread-block clusters that
// split Dh where one block cannot hold the head: the kernel template and its C
// entry point. Each source defines MMU_BWD_PLAIN_DIMS before including this
// header and holds the instances it names (both dtypes, no dropout):
//   * attention_bwd_wide.cu  Dh 384, 768 (clusters of 2 and 4 blocks);
//   * attention_bwd_256.cu   Dh 256 (FLAVA fusion's default 3 heads).
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_bwd_impl
// :813 (body _attn_bwd_kernel_hl :443) and _sdpa_flash_bwd_impl :1219 (bodies
// _attn_kernel_flash_dq :1105 and _attn_kernel_flash_dkv :1151) at FLAVA
// fusion's 3, 2 and 1 heads of D=768; attention_flash reaches the same at any S.
//
// Function and contract: those of attention_bwd.cuh, unchanged. Three
// launches: delta = rowsum(dO * O) per (row, head); a dQ pass over query
// blocks looping over key tiles; a dK/dV pass over key blocks looping over
// query tiles. Each block owns its output rows and columns: no atomics, the
// result is deterministic. No (S, S) plane goes to device memory. P =
// exp(s * scale + bias - lse) in fp32 from the forward's lse; masked keys take
// the finite -1e30 after the scaled product, keys past S weigh exactly 0, and
// a query row with lse <= -5e29 (all its keys masked) takes P = 1/S, the
// gradient of the forward's uniform average. P (for P^T dO) and dS = P (dP -
// delta) (for dS K and dS^T Q) are rounded to the input dtype before their
// products; every product sums in fp32. q, k, v are read through base
// pointers with one row stride, dq, dk, dv written with their own (the packed
// (B, S, 3D) projection and its gradient in place); out and dout dense
// (B, S, D); lse and delta (B, H, S) fp32; 64-bit offsets, any S.
//
// What bounds the work: the fp32 FMA units. The two passes execute 14 B S^2 D
// flops (S and dP are recomputed in both, so that each block keeps its
// outputs in registers): 141 GFLOP at B=128, S=320, D=768, 2.1 ms at 67
// TFLOP/s. The bytes (~8 B S D itemsize) are a hundredth of that. Measured on
// an H100 80GB HBM3 at 700 W (tools/bench_attention.py, that shape, fp32):
// 5.0 / 4.7 / 5.4 ms at Dh 256 / 384 / 768, 39-45 % of the fp32 rate. At Dh
// 256, with parts removed one at a time: the scores (S and dP in both passes)
// ~2.2 ms, at ~55 % of the FMA rate; the products ~1.6 ms, ~57 %; P and dS
// ~0.3 ms; the rest (prologue loads, barriers, epilogue) ~1.3 ms.
//
// Design. An instance is (N, C, R): a cluster of N blocks owns R rows
// (queries in the dQ pass, keys in the dK/dV pass), each block a C-column
// slice of Dh = N C. The 256 KB register file of an SM holds the dK and dV
// accumulators of 2 R C fp32 values, 64 or 96 a thread:
//   * Dh 768 / 384: N = 4 / 2, C = 192, R = 64 (96 accumulators a thread);
//   * Dh 256: N = 1, C = 256, R = 32 (64 a thread, no cluster: the cluster
//     path compiles out).
// A block:
//   * keeps its slice of the own rows' two operands (q and dO, or k and v) in
//     shared memory, its slice of dQ, or of dK and dV, in registers;
//   * streams the other operands (k and v, or q and dO) in 32-row tiles of
//     its slice through a two-stage cp.async ring (fp32 straight into the
//     swizzled tile; bf16 into a staging ring, then widened once into an fp32
//     working tile): the next tile's loads are issued once the block is past
//     the previous tile's products, and overlap this tile's P, dS and products;
//   * for each tile computes the partial S and dP (R x 32 each) over its
//     slice and publishes it in its shared memory; after a barrier.cluster,
//     each block sums 1/N of the positions over the N blocks (distributed
//     shared memory, in rank order), forms their P and dS and writes them,
//     rounded, into every block's P / dS tile; a second barrier and the
//     products go on locally. Nothing is recomputed, nothing goes through
//     device memory. With N = 1 both barriers are __syncthreads.
// What bounds this design is shared memory, not the FMAs: every product
// accumulates in per-thread register micro-tiles, so that each 16-byte load
// (mostly broadcast within a quarter warp) feeds several FMAs:
//   * scores: 4 x R/8 (rows x tile rows) a thread; the Dh reduction is split
//     between two warp pairs, whose partial tiles are summed through shared
//     memory before the cluster's sum;
//   * products: R/8 x 4 C/64 (rows x columns) a thread: dK and dV on two
//     halves of the block, or dQ with the tile's rows split between them and
//     summed once at the end.
// In every load the 8 threads of a quarter warp hit distinct banks or the
// same word (at: the 16-byte chunk c of row r sits at c ^ (r % 8)).
// Shared memory: 2 R C own rows + 2 x 2 x 32 C stream ring (bf16: staging +
// working tile in the same bytes) + 2 x 2 x R x 32 partials and P / dS (the
// latter first the second half's partial scores) + 1 KB row info, in fp32
// words: 225 KB at C = 192, 161 KB at (C, R) = (128, 64), 209 KB at (256,
// 32); one block an SM. Left for later: the next tile's scores during the
// second barrier (a deeper pipeline, if the registers allow), bf16 (and
// TF32, were it allowed) on wgmma, a persistent grid, one pass with dQ by
// atomics.
#pragma once
#include "attention_cluster.cuh"

namespace {

// The instance of one head dim: N blocks a cluster, C columns a block, R rows.
template <int DH>
struct Wide;
template <>
struct Wide<768> {
  static constexpr int N = 4, C = 192, R = 64;
};
template <>
struct Wide<384> {
  static constexpr int N = 2, C = 192, R = 64;
};
template <>
struct Wide<256> {  // attention_bwd_256.cu says why this shape
  static constexpr int N = 1, C = 256, R = 32;
};

template <int N, int C, int R>
struct Shape {
  static_assert(C % 64 == 0 && (R == 32 || R == 64) && (R * kT / 4) % N == 0, "no such shape");
  static constexpr int kChunks = C / 4;         // 16-byte fp32 chunks of a slice row
  static constexpr int kOwnFloats = 2 * R * C;  // two operands, swizzled rows of C floats
  static constexpr int kTileFloats = 2 * kT * C;  // two operands of one streamed tile
  static constexpr int kPartFloats = 2 * R * kT;  // the block's partial S' and dP'
  static constexpr int kPdsFloats = 2 * R * kT;   // P and dS, swizzled rows of kT floats
  static constexpr int kSlots = R * kT / 4;       // float4 slots of each partial
  // scores: 4 rows (rg + kRG i) x kMJ tile rows (tg + kTG j) a thread, 64
  // threads a matrix and half of the slice
  static constexpr int kMJ = R / 8;
  static constexpr int kRG = R / 4;
  static constexpr int kTG = kT / kMJ;
  static constexpr int kK = kMJ;  // float4 slots a thread publishes
  // products: kPI rows (prg + 8 i) x kPJ chunks (pcg + 16 j) a thread
  static constexpr int kPI = R / 8;
  static constexpr int kPJ = C / 64;
  // fp32: a ring of two fp32 tiles; bf16: one fp32 working tile and a ring of
  // two bf16 staging tiles (the same bytes)
  static constexpr int kBytes =
      (kOwnFloats + 2 * kTileFloats + kPartFloats + kPdsFloats) * 4 + 2 * kT * 16;
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_wide_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                                float* __restrict__ delta, int B, int S, int H, int DH) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kWarps + warp;  // b * S + s
  if (row >= (long long)B * S) return;
  const int b = (int)(row / S);
  const int s = (int)(row % S);
  const int D = H * DH;
  const T* o = out + row * D;
  const T* g = dout + row * D;
  for (int h = 0; h < H; ++h) {
    float acc = 0.f;
    for (int c = lane; c < DH; c += 32) {
      acc = fmaf(to_float(o[h * DH + c]), to_float(g[h * DH + c]), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) delta[((long long)b * H + h) * S + s] = acc;
  }
}

// The barrier between the cluster's blocks (N = 1: the block's).
template <int N>
__device__ __forceinline__ void rendezvous() {
  if constexpr (N == 1)
    __syncthreads();
  else
    cluster_sync();
}

// Passes 2 and 3. DKV false: the dQ pass, own rows = queries (A0 = q, A1 =
// dO), streamed rows = keys (B0 = k, B1 = v), dQ += dS k. DKV true: the dK/dV
// pass, own rows = keys (A0 = k, A1 = v), streamed = queries (B0 = q, B1 =
// dO), dK += dS^T q, dV += P^T dO. Either way the scores of the pass are
// S' = A0 B0^T and dP' = A1 B1^T over Dh (the transposes in the dK/dV pass).
//
// The block's 8 warps take three roles a tile:
//   * scores: warps 0-3 S', warps 4-7 dP'; warp pairs (0, 1) and (2, 3) sum
//     the slice's first and second halves of columns: 64 threads cover the
//     R x 32 tile in 4 x R/8 micro-tiles, rows rg + R/4 i, tile rows tg +
//     32/(R/8) j. The second half's partials go through shared memory to the
//     first, which publishes the block's partial to the cluster;
//   * P and dS: R 8 / N threads each sum, over the cluster, 4 positions of
//     each partial (the block's 1/N share) and form and write their P and dS;
//   * products: two groups of 128 threads, each R/8 rows x 4 C/64 columns a
//     thread (rows prg + 8 i, the slice's chunks pcg + 16 j). dK/dV pass:
//     group 0 dK += dS^T q, group 1 dV += P^T dO over the whole tile. dQ
//     pass: both dQ += dS k, group 0 over the tile's first 16 rows, group 1
//     over the other 16; the two partial dQs are summed once, at the end.
template <typename T, int N, int C, int R, bool DKV>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, long long row_stride,
                          const uint8_t* __restrict__ mask, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ d0, T* __restrict__ d1, long long grad_stride, int S,
                          int H, float scale) {
  using Sh = Shape<N, C, R>;
  constexpr int DH = N * C;
  constexpr int kMJ = Sh::kMJ, kRG = Sh::kRG, kTG = Sh::kTG, kK = Sh::kK;
  constexpr int kPI = Sh::kPI, kPJ = Sh::kPJ, kSlots = Sh::kSlots;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(128) float smem[];
  float* own = smem;                               // [2][R][C]: A0, A1
  float* stream = own + Sh::kOwnFloats;            // fp32: [2 stages][2][kT][C]; bf16: work tile
  float4* part = reinterpret_cast<float4*>(stream + 2 * Sh::kTileFloats);  // [2][kK][64]: S', dP'
  float* pds = stream + 2 * Sh::kTileFloats + Sh::kPartFloats;  // [2][R][kT]: P, dS
  float4* rinfo = reinterpret_cast<float4*>(pds + Sh::kPdsFloats);  // [2 stages][kT]
  // bf16: the staging ring is the second half of the stream area
  T* staging = reinterpret_cast<T*>(stream + Sh::kTileFloats);  // [2 stages][2][kT][C]

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

  const T* a0 = DKV ? k + qkv_off : q + qkv_off;
  const T* a1 = DKV ? v + qkv_off : dout + dout_off;
  const long long a1_stride = DKV ? row_stride : D;
  const T* b0 = DKV ? q + qkv_off : k + qkv_off;
  const T* b1 = DKV ? dout + dout_off : v + qkv_off;
  const long long b1_stride = DKV ? D : row_stride;

  // Streamed tile t0 into stage `stage`, with its rows' info: keys (dQ pass)
  // .x = exponent bias, .y = exists; queries (dK/dV pass) .x = lse, .y =
  // delta, .z = exists.
  auto prefetch = [&](int stage, int t0) {
    if constexpr (kBf16) {
      stage_rows<C>(staging + stage * 2 * kT * C, b0, row_stride, b1, b1_stride, t0, S);
    } else {
      float* st = stream + stage * Sh::kTileFloats;
      load_rows<kT, C>(st, b0, row_stride, t0, S);
      load_rows<kT, C>(st + kT * C, b1, b1_stride, t0, S);
    }
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
  load_rows<R, C>(own + R * C, a1, a1_stride, r0, S);
  prefetch(0, 0);

  // score roles: matrix sm (0: S', 1: dP'), half hf of the slice's chunks
  const int sm = warp / 4, hf = (warp / 2) % 2, i64 = (warp % 2) * 32 + lane;
  const int rg = i64 / kTG, tg = i64 % kTG;
  // P / dS role (threads tid < kSlots / N): the partials' float4 slot pkk, pi64
  // (kSlots of each matrix) of this block's share, i.e. row prow and tile rows
  // ptg + kTG (4 (pkk % (kMJ / 4)) + e), e < 4
  const int slot = rank * (kSlots / N) + tid % (kSlots / N);
  const int pkk = slot / 64, pi64 = slot % 64;
  const int prow = pi64 / kTG + kRG * (pkk / (kMJ / 4)), ptg = pi64 % kTG;
  const int pt0 = ptg + kTG * 4 * (pkk % (kMJ / 4));
  // product roles: group pg, rows prg + 8 i (i < kPI), chunks pcg + 16 j (j < kPJ)
  const int pg = warp / 4, prg = (tid % 128) / 16, pcg = tid % 16;

  // the P / dS row's info: dQ pass (a query) lse, delta; dK/dV pass (a key)
  // exponent bias, exists
  float own_x, own_y;
  {
    const int s = r0 + prow;
    if constexpr (DKV) {
      own_x = s < S && key_mask && !key_mask[s] ? kMaskBias : 0.f;
      own_y = s < S ? 1.f : 0.f;
    } else {
      own_x = s < S ? lse[stat_off + s] : 0.f;
      own_y = s < S ? delta[stat_off + s] : 0.f;
    }
  }

  float4 acc[kPI][kPJ];
#pragma unroll
  for (int i = 0; i < kPI; ++i)
#pragma unroll
    for (int j = 0; j < kPJ; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  const float* A = own + sm * R * C;
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
    const float* B0;
    if constexpr (kBf16) {  // widen the staged tile into the work tile
      widen_stage<C>(stream, staging + stage * 2 * kT * C);
      __syncthreads();
      B0 = stream;
    } else {
      B0 = stream + stage * Sh::kTileFloats;
    }
    const float4* info = rinfo + stage * kT;

    // this thread's partial of S' or dP' over its half of the slice
    float x[4][kMJ];
    partial_scores<C, R>(A, B0 + sm * kT * C, rg, tg, hf * (Sh::kChunks / 2), x);
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
    if (tid < kSlots / N) {
      float4 ss, dd;
      if constexpr (N == 1) {
        ss = part[pkk * 64 + pi64];
        dd = part[(kK + pkk) * 64 + pi64];
      } else {
        ss = make_float4(0.f, 0.f, 0.f, 0.f), dd = ss;
#pragma unroll
        for (int r = 0; r < N; ++r) {
          ss = add4(ss, ld_cluster4(part_addr + 16 * (pkk * 64 + pi64), r));
          dd = add4(dd, ld_cluster4(part_addr + 16 * ((kK + pkk) * 64 + pi64), r));
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = pt0 + kTG * e;
        const float4 ti = info[t];
        float p, dlt;
        if constexpr (DKV) {  // prow: key, t: query
          p = prob(comp(ss, e) * scale, own_x, ti.x, ti.z != 0.f && own_y != 0.f, inv_s);
          dlt = ti.y;
        } else {  // prow: query, t: key
          p = prob(comp(ss, e) * scale, ti.x, own_x, ti.y != 0.f, inv_s);
          dlt = own_y;
        }
        const int o = at<kT>(prow, t / 4) + t % 4;
        const float ds = round_to(p * (comp(dd, e) - dlt), T());
        const float pr = round_to(p, T());
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
    // dV += P^T dO (group 1)
    const float* Bp = B0 + (DKV && pg ? kT * C : 0);
#pragma unroll 4
    for (int c4 = c4_lo; c4 < c4_hi; ++c4) {
      float4 w4[kPI];
#pragma unroll
      for (int i = 0; i < kPI; ++i) w4[i] = ld4(W + at<kT>(prg + 8 * i, c4));
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const int t = 4 * c4 + tt;
        float4 y[kPJ];
#pragma unroll
        for (int j = 0; j < kPJ; ++j) y[j] = ld4(Bp + at<C>(t, pcg + 16 * j));
#pragma unroll
        for (int i = 0; i < kPI; ++i)
#pragma unroll
          for (int j = 0; j < kPJ; ++j) fma4(acc[i][j], comp(w4[i], tt), y[j]);
      }
    }
  }
  // no block reads or writes this one's shared memory after the last barrier

  const long long out_off = (long long)b * S * grad_stride + col;
  T* dst = d0;
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
    const int s = r0 + prg + 8 * i;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < kPJ; ++j) {
      const long long o = out_off + (long long)s * grad_stride + 4 * (pcg + 16 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) store(dst + o + e, comp(acc[i][j], e) * mul);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, long long row_stride,
                   const void* mask, const void* out, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, long long grad_stride, int B,
                   int S, int H, cudaStream_t stream) {
  constexpr int N = Wide<DH>::N, C = Wide<DH>::C, R = Wide<DH>::R;
  static_assert(N * C == DH, "a cluster's slices make the head");
  constexpr int smem = Shape<N, C, R>::kBytes;
  const float scale = (float)(1.0 / sqrt((double)DH));  // rounded once, as 1.0 / dh**0.5 is
  const T* q_t = static_cast<const T*>(q);
  const T* k_t = static_cast<const T*>(k);
  const T* v_t = static_cast<const T*>(v);
  const T* dout_t = static_cast<const T*>(dout);
  const uint8_t* mask_t = static_cast<const uint8_t*>(mask);

  const long long rows = (long long)B * S;
  attention_bwd_wide_delta_kernel<T><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0,
                                       stream>>>(static_cast<const T*>(out), dout_t, delta, B,
                                                 S, H, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid(((S + R - 1) / R) * N, H, B);
  err = launch_clusters<N>(attention_bwd_wide_kernel<T, N, C, R, false>, grid, smem, stream, q_t,
                           k_t, v_t, row_stride, mask_t, dout_t, lse, delta,
                           static_cast<T*>(dq), static_cast<T*>(nullptr), grad_stride, S, H,
                           scale);
  if (err != cudaSuccess) return err;
  return launch_clusters<N>(attention_bwd_wide_kernel<T, N, C, R, true>, grid, smem, stream,
                            q_t, k_t, v_t, row_stride, mask_t, dout_t, lse, delta,
                            static_cast<T*>(dk), static_cast<T*>(dv), grad_stride, S, H, scale);
}

// The launch of the instance whose head dim is dh, among DHS; an invalid
// value when this library has none.
template <typename T, int... DHS>
cudaError_t dispatch(Dims<DHS...>, int dh, const void* q, const void* k, const void* v,
                     long long row_stride, const void* mask, const void* out, const void* dout,
                     const float* lse, float* delta, void* dq, void* dk, void* dv,
                     long long grad_stride, int B, int S, int H, cudaStream_t stream) {
  if (row_stride % (16 / (long long)sizeof(T))) return cudaErrorInvalidValue;  // 16-byte rows
  cudaError_t err = cudaErrorInvalidValue;
  (void)((dh == DHS && ((err = launch<T, DHS>(q, k, v, row_stride, mask, out, dout, lse, delta,
                                               dq, dk, dv, grad_stride, B, S, H, stream)),
                        true)) ||
         ...);
  return err;
}

}  // namespace

// Plain C entry point (loaded with ctypes), the signature of
// attention_bwd.cuh's. dtype: 0 = float32, 1 = bfloat16; dh: one of
// MMU_BWD_PLAIN_DIMS. q, k, v: (B, S, D) views with row stride row_stride
// (whole 16-byte words, 16-byte aligned bases); mask: (B, S) bytes, nonzero =
// key kept, or NULL; keep must be NULL (no dropout instance at these head
// dims); out, dout: dense (B, S, D); lse: (B, H, S) float32 from the forward;
// delta: (B, H, S) float32 scratch; dq, dk, dv: (B, S, D) views with row
// stride grad_stride. Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for anything this library has no instance of).
extern "C" int mmu_attention_bwd(const void* q, const void* k, const void* v,
                                 long long row_stride, const void* mask, const void* keep,
                                 float inv_keep, const void* out, const void* dout,
                                 const void* lse, void* delta, void* dq, void* dk, void* dv,
                                 long long grad_stride, int B, int S, int H, int dh, int dtype,
                                 int device, void* stream) {
  (void)inv_keep;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (keep != nullptr || B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = dispatch<float>(Dims<MMU_BWD_PLAIN_DIMS>(), dh, q, k, v, row_stride, mask, out, dout,
                          lse_f, delta_f, dq, dk, dv, grad_stride, B, S, H, st);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(Dims<MMU_BWD_PLAIN_DIMS>(), dh, q, k, v, row_stride, mask, out,
                                  dout, lse_f, delta_f, dq, dk, dv, grad_stride, B, S, H, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
