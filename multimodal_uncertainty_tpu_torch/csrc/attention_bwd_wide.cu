// Masked attention backward for Hopper (sm_90a) at the wide head dims, Dh
// 384 and 768, in fp32 and bf16 (fp32 FMAs, no TF32), on thread-block
// clusters that split Dh.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_bwd_impl
// :813 (body _attn_bwd_kernel_hl :443) and _sdpa_flash_bwd_impl :1219 (bodies
// _attn_kernel_flash_dq :1105 and _attn_kernel_flash_dkv :1151) at FLAVA
// fusion's 2 and 1 heads of D=768; attention_flash reaches the same at any S.
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
// an H100 80GB HBM3 at 700 W: 5.4 / 4.7 ms at Dh 768 / 384 in fp32 there,
// 39-44 % of the fp32 rate.
//
// Design. The 256 KB register file of an SM holds the dK and dV accumulators
// of 2 R Dh fp32 values: at Dh=768 R = 32 rows already fill 192 KB, and the
// block's own K and V rows cost as much again in shared memory. So Dh is
// split across a cluster of N = Dh / 192 blocks (4 at Dh=768, 2 at Dh=384):
//   * each block of the cluster owns the same R = 64 rows (queries in the dQ
//     pass, keys in the dK/dV pass) and a 192-column slice of Dh: its slice
//     of the own rows' two operands (q and dO, or k and v) in shared memory
//     (96 KB), its slice of dQ, or of dK and dV, in registers (96 a thread);
//   * the other operands (k and v, or q and dO) stream in 32-row tiles of the
//     block's slice through a two-stage cp.async ring (fp32 straight into the
//     swizzled tile; bf16 into a staging ring, then widened once into an fp32
//     working tile): the next tile's loads are issued once the cluster's first
//     barrier shows the block past the previous tile's products, and overlap
//     this tile's P, dS and products;
//   * for each tile, each block computes the partial S and dP (64 x 32 each)
//     over its slice and publishes it in its shared memory; after a
//     barrier.cluster, each block sums 1/N of the positions over the N blocks
//     (distributed shared memory, in rank order), forms their P and dS and
//     writes them, rounded, into every block's P / dS tile; a second barrier
//     and the products go on locally. Nothing is recomputed, nothing goes
//     through device memory, and a block reads and writes (N - 1) / N of one
//     partial tile remotely a tile.
// What bounds this design is shared memory, not the FMAs: a thread's 16-byte
// load moves 16 of the SM's 128 bytes a clock, so each loaded word must feed
// at least 4 FMAs for the 128 FMA lanes to stay busy. Every product therefore
// accumulates in per-thread register micro-tiles:
//   * scores: 4 x 8 (rows x tile rows) a thread, each loaded word feeding 8 or
//     4 FMAs (2.7 on average); the Dh reduction is split between two warp
//     pairs, whose partial tiles are summed through shared memory before the
//     cluster's sum (a generalised split_sum);
//   * products: 8 x 12 (rows x columns) a thread, each loaded word feeding 12
//     or 8 (4.8 on average): dK and dV on two halves of the block, or dQ with
//     the tile's rows split between them and summed once at the end.
// In every load the 8 threads of a quarter warp hit distinct banks or the
// same word (the 16-byte chunk c of row r sits at c ^ (r % 8)).
// Shared memory: 96 KB own rows + 96 KB stream ring (bf16: 48 KB staging +
// 48 KB working tile) + 16 KB partials + 16 KB P / dS (first the second
// half's partial scores) + 1 KB row info = 225 KB, one block an SM; the ring
// hides the loads.
// bf16 here runs on the fp32 FMA units (operands widened once, in shared
// memory): no tensor cores. Left for later: the next tile's scores during the
// second cluster barrier (a deeper pipeline, if the registers allow), bf16
// (and TF32, were it allowed) on wgmma, a persistent grid, one pass with dQ
// by atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kC = 192;        // the Dh columns of a block's slice
constexpr int kChunks = kC / 4;  // 16-byte fp32 chunks of a slice row
constexpr int kR = 64;         // rows a block owns
constexpr int kT = 32;         // rows of a streamed tile
constexpr float kMaskBias = -1e30f;  // ops/attention.py NEG_INF

constexpr int kOwnFloats = 2 * kR * kC;    // two operands, swizzled rows of kC floats
constexpr int kTileFloats = 2 * kT * kC;   // two operands of one streamed tile
constexpr int kPartFloats = 2 * kR * kT;   // the block's partial S' and dP'
constexpr int kSlots = kR * kT / 4;        // float4 slots of each partial
constexpr int kPdsFloats = 2 * kR * kT;    // P and dS, swizzled rows of kT floats

template <typename T>
struct Smem {
  // fp32: a ring of two fp32 tiles; bf16: one fp32 working tile and a ring of
  // two bf16 staging tiles (the same bytes)
  static constexpr int kStreamBytes = 2 * kTileFloats * 4;
  static constexpr int kBytes = (kOwnFloats + kPartFloats + kPdsFloats) * 4 + kStreamBytes +
                                2 * kT * 16;  // + the streamed rows' info, two stages
};

// Float offset of 16-byte chunk c of row r in a swizzled tile of kC-float rows.
__device__ __forceinline__ int at(int r, int c) { return r * kC + ((c ^ (r & 7)) << 2); }

// The same in a P / dS tile of kT-float rows.
__device__ __forceinline__ int at_p(int r, int c) { return r * kT + ((c ^ (r & 7)) << 2); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

// barrier.cluster: arrive releases this thread's shared-memory writes, wait
// acquires the other blocks'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The float4 at shared address addr of the cluster's block `rank`.
__device__ __forceinline__ float4 ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// Store x at shared address addr of the cluster's block `rank`.
__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t rank, float x) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote), "f"(x) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ float comp(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// bf16 -> fp32 is exact: a bf16 is the top half of an fp32. Each 32-bit word
// holds two bf16, the first in its low half (little-endian).
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Eight bf16 (one 16-byte word) as two fp32 chunks c, c + 1 of row r.
__device__ __forceinline__ void widen8(float* tile, int r, int c, uint4 w) {
  *reinterpret_cast<float4*>(tile + at(r, c)) =
      make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
  *reinterpret_cast<float4*>(tile + at(r, c + 1)) =
      make_float4(bf16_lo(w.z), bf16_hi(w.z), bf16_lo(w.w), bf16_hi(w.w));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16(x); }

// Rows [row0, row0 + rows) of one operand's slice (kC values a row from
// base) into the swizzled fp32 tile; rows at or past S are zero-filled. fp32
// goes through cp.async (committed by the caller), bf16 through registers.
template <int ROWS>
__device__ __forceinline__ void load_rows(float* tile, const float* base, long long stride,
                                          int row0, int S) {
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int s = row0 + r;
    cp_async16(smem_u32(tile + at(r, c)), base + (long long)min(s, S - 1) * stride + 4 * c,
               s < S);
  }
}

template <int ROWS>
__device__ __forceinline__ void load_rows(float* tile, const __nv_bfloat16* base,
                                          long long stride, int row0, int S) {
  for (int i = threadIdx.x; i < ROWS * kChunks / 2; i += kThreads) {
    const int r = i / (kChunks / 2), c8 = i % (kChunks / 2);
    const int s = row0 + r;
    const uint4 w = s < S ? *reinterpret_cast<const uint4*>(base + (long long)s * stride + 8 * c8)
                          : make_uint4(0u, 0u, 0u, 0u);
    widen8(tile, r, 2 * c8, w);
  }
}

// x[i][j] += sum over chunks [c0, c0 + 24) of a[rg + 16 i] . b[tg + 4 j]
// (swizzled tiles of kC-float rows): 4 rows x 8 tile rows a thread, 12
// float4 loads for 128 FMAs.
__device__ __forceinline__ void partial_scores(const float* a, const float* b, int rg, int tg,
                                               int c0, float (&x)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) x[i][j] = 0.f;
#pragma unroll 4
  for (int c = c0; c < c0 + kChunks / 2; ++c) {
    float4 bj[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) bj[j] = ld4(b + at(tg + 4 * j, c));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 ai = ld4(a + at(rg + 16 * i, c));
#pragma unroll
      for (int j = 0; j < 8; ++j) x[i][j] = dot4(ai, bj[j], x[i][j]);
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
#pragma unroll
    for (int o2 = 16; o2 > 0; o2 >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o2);
    if (lane == 0) delta[((long long)b * H + h) * S + s] = acc;
  }
}

// Passes 2 and 3. DKV false: the dQ pass, own rows = queries (A0 = q, A1 =
// dO), streamed rows = keys (B0 = k, B1 = v), dQ += dS k. DKV true: the dK/dV
// pass, own rows = keys (A0 = k, A1 = v), streamed = queries (B0 = q, B1 =
// dO), dK += dS^T q, dV += P^T dO. Either way the scores of the pass are
// S' = A0 B0^T and dP' = A1 B1^T over Dh (the transposes in the dK/dV pass).
//
// The block's 8 warps take three roles a tile:
//   * scores: warps 0-3 S', warps 4-7 dP'; warp pairs (0, 1) and (2, 3) sum
//     the slice's first and second 96 columns: 64 threads cover the 64 x 32
//     tile in 4 x 8 micro-tiles, rows rg + 16 i, tile rows tg + 4 j. The
//     second half's partials go through shared memory to the first, which
//     publishes the block's partial to the cluster;
//   * P and dS: 512 / N threads each sum, over the cluster, 4 positions of
//     each partial (the block's 1/N share) and form and write their P and dS;
//   * products: two groups of 128 threads, each 8 rows x 12 columns a thread
//     (rows prg + 8 i, the slice's chunks pcg + 16 j). dK/dV pass: group 0
//     dK += dS^T q, group 1 dV += P^T dO over the whole tile. dQ pass: both
//     dQ += dS k, group 0 over the tile's first 16 rows, group 1 over the
//     other 16; the two partial dQs are summed once, at the end.
template <typename T, int N, bool DKV>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, long long row_stride,
                          const uint8_t* __restrict__ mask, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ d0, T* __restrict__ d1, long long grad_stride, int S,
                          int H, float scale) {
  constexpr int DH = N * kC;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(128) float smem[];
  float* own = smem;                               // [2][kR][kC]: A0, A1
  float* stream = own + kOwnFloats;                // fp32: [2 stages][2][kT][kC]; bf16: work tile
  float4* part = reinterpret_cast<float4*>(stream + 2 * kTileFloats);  // [2][8][64]: S', dP'
  float* pds = stream + 2 * kTileFloats + kPartFloats;  // [2][kR][kT]: P, dS
  float4* rinfo = reinterpret_cast<float4*>(pds + kPdsFloats);  // [2 stages][kT]
  // bf16: the staging ring is the second half of the stream area
  T* staging = reinterpret_cast<T*>(stream + kTileFloats);  // [2 stages][2][kT][kC]

  const int rank = (int)cluster_rank();
  const int r0 = (int)cluster_id() * kR, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = H * DH;
  const long long col = (long long)h * DH + rank * kC;  // this block's slice of the head
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
      T* st = staging + stage * 2 * kT * kC;
      for (int i = tid; i < 2 * kT * (kC / 8); i += kThreads) {
        const int m = i / (kT * (kC / 8)), rem = i % (kT * (kC / 8));
        const int r = rem / (kC / 8), c8 = rem % (kC / 8);
        const int s = t0 + r;
        const T* src = (m ? b1 + (long long)min(s, S - 1) * b1_stride
                          : b0 + (long long)min(s, S - 1) * row_stride) + 8 * c8;
        cp_async16(smem_u32(st + (m * kT + r) * kC + 8 * c8), src, s < S);
      }
    } else {
      float* st = stream + stage * kTileFloats;
      load_rows<kT>(st, b0, row_stride, t0, S);
      load_rows<kT>(st + kT * kC, b1, b1_stride, t0, S);
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

  load_rows<kR>(own, a0, row_stride, r0, S);
  load_rows<kR>(own + kR * kC, a1, a1_stride, r0, S);
  prefetch(0, 0);

  // score roles: matrix sm (0: S', 1: dP'), half hf of the slice's chunks
  const int sm = warp / 4, hf = (warp / 2) % 2, i64 = (warp % 2) * 32 + lane;
  const int rg = i64 / 4, tg = i64 % 4;
  // P / dS role (threads tid < kSlots / N): the partials' float4 slot pkk, pi64
  // (kSlots of each matrix) of this block's share, i.e. row prow and tile rows
  // ptg + 4 (4 (pkk % 2) + e), e < 4
  const int slot = rank * (kSlots / N) + tid % (kSlots / N);
  const int pkk = slot / 64, pi64 = slot % 64;
  const int prow = pi64 / 4 + 16 * (pkk / 2), ptg = pi64 % 4;
  // product roles: group pg, rows prg + 8 i (i < 8), chunks pcg + 16 j (j < 3)
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

  float4 acc[8][3];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  const float* A = own + sm * kR * kC;
  float* P = pds;
  float* dS = pds + kR * kT;
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
      const T* st = staging + stage * 2 * kT * kC;
      for (int i = tid; i < 2 * kT * (kC / 8); i += kThreads) {
        const int m = i / (kT * (kC / 8)), rem = i % (kT * (kC / 8));
        const int r = rem / (kC / 8), c8 = rem % (kC / 8);
        widen8(stream + m * kT * kC, r, 2 * c8,
               *reinterpret_cast<const uint4*>(st + (m * kT + r) * kC + 8 * c8));
      }
      __syncthreads();
      B0 = stream;
    } else {
      B0 = stream + stage * kTileFloats;
    }
    const float4* info = rinfo + stage * kT;

    // this thread's partial of S' or dP' over its half of the slice
    float x[4][8];
    partial_scores(A, B0 + sm * kT * kC, rg, tg, hf * (kChunks / 2), x);
    if (hf) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        scratch[(sm * 8 + kk) * 64 + i64] =
            make_float4(x[kk / 2][4 * (kk % 2)], x[kk / 2][4 * (kk % 2) + 1],
                        x[kk / 2][4 * (kk % 2) + 2], x[kk / 2][4 * (kk % 2) + 3]);
    }
    __syncthreads();
    // the cluster's sums, reduce-scatter then all-gather: each block sums
    // 1/N of the positions over the cluster (in rank order) and writes their
    // P and dS into every block
    if (!hf) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const float4 y = scratch[(sm * 8 + kk) * 64 + i64];
        part[(sm * 8 + kk) * 64 + i64] =
            make_float4(x[kk / 2][4 * (kk % 2)] + y.x, x[kk / 2][4 * (kk % 2) + 1] + y.y,
                        x[kk / 2][4 * (kk % 2) + 2] + y.z, x[kk / 2][4 * (kk % 2) + 3] + y.w);
      }
    }
    cluster_arrive();  // the block's partials are published ...
    cluster_wait();    // ... and the cluster's: from here on remote blocks write P and dS
    // every thread of the block is past tile it - 1's products: its stage is free
    if (it + 1 < n_tiles) prefetch(stage ^ 1, (it + 1) * kT);
    if (tid < kSlots / N) {
      float4 ss = make_float4(0.f, 0.f, 0.f, 0.f), dd = ss;
#pragma unroll
      for (int r = 0; r < N; ++r) {
        const float4 y = ld_cluster(part_addr + 16 * (pkk * 64 + pi64), r);
        const float4 z = ld_cluster(part_addr + 16 * ((8 + pkk) * 64 + pi64), r);
        ss = make_float4(ss.x + y.x, ss.y + y.y, ss.z + y.z, ss.w + y.w);
        dd = make_float4(dd.x + z.x, dd.y + z.y, dd.z + z.z, dd.w + z.w);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = ptg + 4 * (4 * (pkk % 2) + e);
        const float4 ti = info[t];
        float p, dlt;
        if constexpr (DKV) {  // prow: key, t: query
          p = prob(comp(ss, e) * scale, own_x, ti.x, ti.z != 0.f && own_y != 0.f, inv_s);
          dlt = ti.y;
        } else {  // prow: query, t: key
          p = prob(comp(ss, e) * scale, ti.x, own_x, ti.y != 0.f, inv_s);
          dlt = own_y;
        }
        const uint32_t o = pds_addr + 4 * (at_p(prow, t / 4) + t % 4);
        const float ds = round_to(p * (comp(dd, e) - dlt), T());
        const float pr = round_to(p, T());
#pragma unroll
        for (int r = 0; r < N; ++r) {
          st_cluster(o + 4 * kR * kT, r, ds);
          if constexpr (DKV) st_cluster(o, r, pr);
        }
      }
    }
    cluster_arrive();  // this block's P and dS are written, its partials read ...
    cluster_wait();    // ... and every block's

    // dQ += dS k (group pg: tile rows 16 pg ..), or dK += dS^T q (group 0) and
    // dV += P^T dO (group 1)
    const float* Bp = B0 + (DKV && pg ? kT * kC : 0);
#pragma unroll 4
    for (int c4 = c4_lo; c4 < c4_hi; ++c4) {
      float4 w4[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) w4[i] = ld4(W + at_p(prg + 8 * i, c4));
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const int t = 4 * c4 + tt;
        float4 y[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) y[j] = ld4(Bp + at(t, pcg + 16 * j));
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) fma4(acc[i][j], comp(w4[i], tt), y[j]);
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
    float4* half = reinterpret_cast<float4*>(stream);  // [8][3][128]
    __syncthreads();  // the stream area is consumed
    if (pg) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) half[(i * 3 + j) * 128 + tid % 128] = acc[i][j];
    }
    __syncthreads();
    if (pg) return;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float4 y = half[(i * 3 + j) * 128 + tid];
        acc[i][j].x += y.x;
        acc[i][j].y += y.y;
        acc[i][j].z += y.z;
        acc[i][j].w += y.w;
      }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = r0 + prg + 8 * i;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const long long o = out_off + (long long)s * grad_stride + 4 * (pcg + 16 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) store(dst + o + e, comp(acc[i][j], e) * mul);
    }
  }
}

template <typename T, int N, bool DKV>
cudaError_t launch_pass(const dim3& grid, cudaStream_t stream, const T* q, const T* k,
                        const T* v, long long row_stride, const uint8_t* mask, const T* dout,
                        const float* lse, const float* delta, T* d0, T* d1,
                        long long grad_stride, int S, int H, float scale) {
  constexpr int smem = Smem<T>::kBytes;
  auto kernel = attention_bwd_wide_kernel<T, N, DKV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, q, k, v, row_stride, mask, dout, lse, delta, d0, d1,
                            grad_stride, S, H, scale);
}

template <typename T, int N>
cudaError_t launch(const void* q, const void* k, const void* v, long long row_stride,
                   const void* mask, const void* out, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, long long grad_stride, int B,
                   int S, int H, cudaStream_t stream) {
  constexpr int DH = N * kC;
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

  const dim3 grid(((S + kR - 1) / kR) * N, H, B);
  err = launch_pass<T, N, false>(grid, stream, q_t, k_t, v_t, row_stride, mask_t, dout_t, lse,
                                 delta, static_cast<T*>(dq), nullptr, grad_stride, S, H, scale);
  if (err != cudaSuccess) return err;
  return launch_pass<T, N, true>(grid, stream, q_t, k_t, v_t, row_stride, mask_t, dout_t, lse,
                                 delta, static_cast<T*>(dk), static_cast<T*>(dv), grad_stride, S,
                                 H, scale);
}

template <typename T>
cudaError_t dispatch(int dh, const void* q, const void* k, const void* v, long long row_stride,
                     const void* mask, const void* out, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv, long long grad_stride, int B,
                     int S, int H, cudaStream_t stream) {
  if (row_stride % (16 / (long long)sizeof(T))) return cudaErrorInvalidValue;  // 16-byte rows
  if (dh == 384)
    return launch<T, 2>(q, k, v, row_stride, mask, out, dout, lse, delta, dq, dk, dv,
                        grad_stride, B, S, H, stream);
  if (dh == 768)
    return launch<T, 4>(q, k, v, row_stride, mask, out, dout, lse, delta, dq, dk, dv,
                        grad_stride, B, S, H, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes), the signature of
// attention_bwd.cuh's. dtype: 0 = float32, 1 = bfloat16; dh: 384 or 768.
// q, k, v: (B, S, D) views with row stride row_stride (whole 16-byte
// words, 16-byte aligned bases); mask: (B, S) bytes, nonzero = key kept, or
// NULL; keep must be NULL (no dropout instance at these head dims); out,
// dout: dense (B, S, D); lse: (B, H, S) float32 from the forward; delta:
// (B, H, S) float32 scratch; dq, dk, dv: (B, S, D) views with row stride
// grad_stride. Returns the cudaError_t of the launches
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
    err = dispatch<float>(dh, q, k, v, row_stride, mask, out, dout, lse_f, delta_f, dq, dk, dv,
                          grad_stride, B, S, H, st);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(dh, q, k, v, row_stride, mask, out, dout, lse_f, delta_f, dq,
                                  dk, dv, grad_stride, B, S, H, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
