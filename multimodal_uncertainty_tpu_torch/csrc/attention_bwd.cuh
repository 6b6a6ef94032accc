// Masked multi-head attention backward for Hopper (sm_90a), fp32 and bf16.
//
// The kernel templates and their C entry point. Each attention_bwd*.cu file
// defines MMU_BWD_PLAIN_DIMS (and MMU_BWD_DROPOUT_DIMS) before including this
// header, so the instances compile in separate nvcc processes, started
// together (ops/_build.py), and each library holds the head dims it names:
//   * attention_bwd.cu       Dh 32, 64, 128 (bf16: 32, 128), and the dropout
//                            instances (Dh 32, 64);
//   * attention_bwd_k6.cu    Dh 24, 48, 96, 192.
// Dh 256, 384 and 768 have a kernel of their own on register micro-tiles and
// thread-block clusters, attention_bwd_wide.cuh (instances
// attention_bwd_256.cu and attention_bwd_wide.cu), which does not include
// this header; bf16 at Dh=64 without dropout runs on the tensor cores,
// attention_bwd_tc.cu.
//
// Replaces these Pallas TPU kernels of multimodal_uncertainty_tpu/ops/attention.py:
//   * _sdpa_packed_bwd_impl (body _attn_bwd_kernel_hl): the whole-sequence
//     backward that recomputes P and writes dQ | dK | dV into the packed
//     (B, S, 3D) layout of the QKV projection's gradient;
//   * _sdpa_flash_bwd_impl (bodies _attn_kernel_flash_dq and
//     _attn_kernel_flash_dkv, with delta = rowsum(dO * O) from _flash_delta):
//     the blocked backward that rebuilds P from the forward's log-sum-exp;
//   * _sdpa_hl_bwd_impl (body _attn_bwd_kernel_hl): the same backward on
//     BERT's separate heads-last q, k, v (Dh 64; Dh 32 for the tiny config);
//   * _sdpa_pallas_hl_drop_bwd (body _attn_bwd_kernel_hl_drop): the backward
//     chained through dropout on the attention probabilities, from the uint8
//     (B, H, S, S) keep mask the forward used (the DROPOUT instances);
//   * _sdpa_bwd_impl (body _attn_bwd_kernel): the heads-first (B, H, S, Dh)
//     backward of the custom VJP _sdpa_pallas, which the TPU takes for head
//     dims that are neither a multiple nor a divisor of 128 (Dh 24, 48, 96,
//     192 at D=768). It recomputes the softmax where this backward reads the
//     forward's LSE; the products are the same;
//   * _sdpa_flash_bwd_stream_impl :1521 (bodies _attn_kernel_flash_dq_stream
//     :1374 and _attn_kernel_flash_dkv_stream :1421): the long-context
//     backward (K4, reached through attention_flash) with nothing of the
//     sequence resident. Here the dQ and dK/dV passes stream key and query
//     tiles from device memory at any S (64-bit offsets), so K4 in fp32 is
//     this body too (in bf16 it is attention_bwd_tc.cu's).
// The TPU needed both because the whole-sequence score plane stops fitting
// VMEM past S ~ 574 at fp32. Here three launches cover every S:
//   1. delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]   (fp32)
//   2. dQ over query tiles, looping over key tiles:
//        P = exp(q k^T * scale + bias - lse), dP = dO v^T,
//        dS = P * (dP - delta), dQ = dS k * scale
//   3. dK, dV over key tiles, looping over query tiles:
//        dV = P^T dO, dK = dS^T q * scale
// Each block owns its output rows, so there are no atomics and the result is
// deterministic (the TPU's dQ / dK-dV split at :1234 and :1256).
//
// Masking contract (the forward's, attention_fwd.cuh): masked keys take
// the finite -1e30 after the scaled product; only keys past S, in the ragged
// last tile, have weight exactly 0. A query row whose keys are all masked has
// lse = -1e30 in fp32, where s - lse would round to 0 and give P = 1 instead
// of the forward's uniform 1/S. Such a row (lse <= -5e29) takes P = 1/S
// explicitly: the gradient of the uniform average, which is what K1, K6 and
// XLA give (the TPU flash kernel K3 writes zeros there; that is not copied).
//
// Dropout (DROPOUT = true, Dh 32 and 64): the forward computed
// O = Pd V with Pd = P * keep * inv_keep, inv_keep = 1 / (1 - rate). So
//   dV = Pd^T dO,   dP = keep * inv_keep * (dO V^T),   dS = P * (dP - delta),
// and dQ, dK as above. The delta pass stays valid unchanged:
//   rowsum(dO * O) = sum_k Pd_k (dO . v_k) = sum_k P_k keep_k inv_keep (dO . v_k)
//                  = sum_k P_k dP_k,
// which is JAX's sum(dp * p) (_attn_bwd_kernel_hl_drop). The keep byte of
// (query, key) is read beside P: coalesced in the dQ pass (a warp's lanes
// hold 32 neighbouring keys of a row); in the dK/dV pass the lanes hold 32
// queries, so a warp reads 32 rows' bytes, which L1 serves to the block's
// other warps (they read the neighbouring keys of the same rows).
//
// Precision: logits, softmax and every product accumulate in fp32; P (for
// P^T dO) and dS (for dS k and dS^T q) are rounded to the input dtype before
// their products, as _attn_bwd_kernel_hl and _attn_bwd_kernel do. Operands
// are widened to fp32 in shared memory.
//
// Layout: q, k and v are read through base pointers and one row stride, so
// the packed projection (row stride 3D) and separate (B, S, D) tensors take
// the same path; dq, dk and dv are written the same way with their own common
// row stride, so the packed gradient lands in its three column slices with no
// concatenation. out and dout are dense (B, S, D); lse and delta (B, H, S).
//
// Head dims that are no multiple of 32 (24, 48): a lane owns output columns
// lane + 32 c for c < ceil(Dh / 32) over tile rows padded to a multiple of 32
// columns and zeroed once; only columns below Dh are stored.
//
// What bounds it: the backward does 10 B S^2 D flops (JAX's CostEstimate) over
// about 8 B S D itemsize bytes: at B=128, S=320, D=768 in fp32 that is ~330
// flops per byte, far past the card's balance point, so it is bound by the
// fp32 FMA units (no TF32). This design recomputes S and dP in both the dQ
// and the dK/dV pass (14 B S^2 D flops executed) to keep each block's output
// in registers with no atomics. Each warp owns 4 rows (queries in pass 2,
// keys in pass 3); a lane owns one column of the 32-wide score tile and
// ceil(Dh/32) output columns, so one shared-memory load feeds 4-8 FMAs (and
// a score load 2: the kernels stay below half the FMA rate, 13-24 % of it
// measured). At Dh=192 in fp32 the four 32-row tiles (Q, dO, K, V) plus the P
// and dS tiles take 109 KB, one block per SM; the dK and dV accumulators cost
// 48 registers a thread. Left for later: TMA or cp.async double-buffering of
// the streamed tiles, and the register micro-tiles that feed more FMAs a load
// (as attention_bwd_wide.cuh does at Dh 256-768).
//
// bf16 here still runs on the fp32 FMA units (operands widened to fp32 in
// shared memory), at the fp32 rate: every bf16 instance of this header is
// far from its tensor-core bound. The one exception is bf16 at Dh=64 without
// dropout (K4 bwd, and K1/K2 bwd at 12 x 64), which attention_bwd_tc.cu runs on
// the tensor cores (wgmma); attention_bwd.cu leaves that instance out
// (MMU_BWD_BF16_PLAIN_DIMS) and ops/attention.py::bwd_source never routes it
// here. Still on the FMA units in bf16: this header's Dh 32, 128, K6's 24-192
// and the dropout instances (Dh 32, 64), and attention_bwd_wide.cuh's 256,
// 384 and 768. Left for later: the tensor-core design for those.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;                        // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;                              // floats of row padding
constexpr float kMaskBias = -1e30f;                  // ops/attention.py NEG_INF

// The tiling of one head dim.
template <int DH>
struct BwdTiles {
  static_assert(DH % 8 == 0, "a head's row slice must be whole 16-byte loads in bf16");
  static_assert(DH <= 192, "Dh 256 and up are attention_bwd_wide.cuh's");
  static constexpr int kRowsPerWarp = 4;
  static constexpr int kRows = kWarps * kRowsPerWarp;  // rows a block owns
  static constexpr int kTile = 32;                     // rows of a streamed tile
  static constexpr int kCols = (DH + 31) / 32;         // output columns a lane owns
  static constexpr int kLd = 32 * kCols + kPad;        // floats a tile row takes
  static constexpr int kSmemDq = ((2 * kRows + 2 * kTile) * kLd + kRows * kTile) * (int)sizeof(float);
  static constexpr int kSmemDkv =
      ((2 * kRows + 2 * kTile) * kLd + 2 * kRows * kTile) * (int)sizeof(float);
};

__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

// bf16 -> fp32 is exact: a bf16 is the top half of an fp32. Each 32-bit word
// holds two bf16, the first in its low half (little-endian).
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  *reinterpret_cast<float4*>(dst) = make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(bf16_lo(w.z), bf16_hi(w.z), bf16_lo(w.w), bf16_hi(w.w));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Copy rows [row0, row0 + rows) of one head (DH values a row) into a float
// tile with row stride LD; rows at or past S are zero-filled. Columns DH..LD
// are left as they are.
template <typename T, int DH, int LD>
__device__ __forceinline__ void load_tile(float* tile, const T* base, long long row_stride,
                                          int row0, int rows, int S) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kVecPerRow = DH / kVec;
  for (int i = threadIdx.x; i < rows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    float* dst = tile + r * LD + c;
    const int s = row0 + r;
    if (s < S) {
      load16(base + (long long)s * row_stride + c, dst);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        *reinterpret_cast<float4*>(dst + e) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

// Zero a block's dynamic shared memory when its rows carry column padding
// that the accumulation loops read (head dims that are no multiple of 32).
template <int DH>
__device__ __forceinline__ void zero_padding(float* smem, int bytes) {
  if constexpr (DH % 32 != 0) {
    for (int i = threadIdx.x; i < bytes / (int)sizeof(float); i += kThreads) smem[i] = 0.f;
    __syncthreads();
  }
}

// P of one (query, key) pair, from the forward's log-sum-exp. Keys past S do
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
attention_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
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

// Pass 2: dQ for the kRows query rows of one (batch, head), looping over key tiles.
template <typename T, int DH, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, long long row_stride,
                        const uint8_t* __restrict__ mask, const uint8_t* __restrict__ keep,
                        float inv_keep, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, long long grad_stride, int S, int H, float scale) {
  using Tiles = BwdTiles<DH>;
  constexpr int kRowsPerWarp = Tiles::kRowsPerWarp;
  constexpr int kRows = Tiles::kRows;
  constexpr int kTile = Tiles::kTile;
  constexpr int kLd = Tiles::kLd;
  constexpr int kCols = Tiles::kCols;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;              // kRows x kLd
  float* g_s = q_s + kRows * kLd;  // kRows x kLd: dO
  float* k_s = g_s + kRows * kLd;  // kTile x kLd
  float* v_s = k_s + kTile * kLd;  // kTile x kLd
  float* ds_s = v_s + kTile * kLd;  // kRows x kTile
  zero_padding<DH>(smem, Tiles::kSmemDq);

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kl = lane;  // the key of the tile this lane scores
  const int D = H * DH;
  const long long head_off = (long long)b * S * row_stride + (long long)h * DH;
  const long long dout_off = (long long)b * S * D + (long long)h * DH;
  const long long stat_off = ((long long)b * H + h) * S;
  const uint8_t* key_mask = mask ? mask + (long long)b * S : nullptr;
  const float inv_s = 1.f / (float)S;

  load_tile<T, DH, kLd>(q_s, q + head_off, row_stride, q0, kRows, S);
  load_tile<T, DH, kLd>(g_s, dout + dout_off, D, q0, kRows, S);

  float row_lse[kRowsPerWarp], row_delta[kRowsPerWarp];
  float acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    row_lse[r] = row < S ? lse[stat_off + row] : 0.f;
    row_delta[r] = row < S ? delta[stat_off + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  const float* q_w = q_s + warp * kRowsPerWarp * kLd;
  const float* g_w = g_s + warp * kRowsPerWarp * kLd;
  float* ds_w = ds_s + warp * kRowsPerWarp * kTile;

  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();  // the previous K and V tiles are consumed (and Q, dO are in)
    load_tile<T, DH, kLd>(k_s, k + head_off, row_stride, k0, kTile, S);
    load_tile<T, DH, kLd>(v_s, v + head_off, row_stride, k0, kTile, S);
    __syncthreads();

    // scores and dP of this warp's rows against key k0 + kl
    float sc[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = dp[r] = 0.f;
    const float* k_l = k_s + kl * kLd;
    const float* v_l = v_s + kl * kLd;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 ka = ld4(k_l + d);
      const float4 va = ld4(v_l + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        sc[r] = dot4(ld4(q_w + r * kLd + d), ka, sc[r]);
        dp[r] = dot4(ld4(g_w + r * kLd + d), va, dp[r]);
      }
    }
    const int key = k0 + kl;
    const bool exists = key < S;
    const float bias = (exists && key_mask && !key_mask[key]) ? kMaskBias : 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float p = prob(sc[r] * scale, bias, row_lse[r], exists, inv_s);
      float d = dp[r];
      if constexpr (DROPOUT) {
        const int row = q0 + warp * kRowsPerWarp + r;
        const bool kept = row < S && exists && keep[(stat_off + row) * S + key];
        d = kept ? d * inv_keep : 0.f;
      }
      ds_w[r * kTile + kl] = round_to(p * (d - row_delta[r]), T());
    }
    __syncwarp();

    // dQ += dS K
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float ds[kRowsPerWarp][4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 x = ld4(ds_w + r * kTile + j);
        ds[r][0] = x.x;
        ds[r][1] = x.y;
        ds[r][2] = x.z;
        ds[r][3] = x.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* k_row = k_s + (j + jj) * kLd + lane;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float kk = k_row[32 * c];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fmaf(ds[r][jj], kk, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= S) continue;
    T* o = dq + ((long long)b * S + row) * grad_stride + (long long)h * DH + lane;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (DH % 32 == 0 || lane + 32 * c < DH) store(o + 32 * c, acc[r][c] * scale);
    }
  }
}

// Pass 3: dK and dV for the kRows keys of one (batch, head), looping over query tiles.
template <typename T, int DH, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, long long row_stride,
                         const uint8_t* __restrict__ mask, const uint8_t* __restrict__ keep,
                         float inv_keep, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, long long grad_stride, int S,
                         int H, float scale) {
  using Tiles = BwdTiles<DH>;
  constexpr int kRowsPerWarp = Tiles::kRowsPerWarp;
  constexpr int kRows = Tiles::kRows;
  constexpr int kTile = Tiles::kTile;
  constexpr int kLd = Tiles::kLd;
  constexpr int kCols = Tiles::kCols;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;               // kRows x kLd: this block's keys
  float* v_s = k_s + kRows * kLd;  // kRows x kLd
  float* q_s = v_s + kRows * kLd;  // kTile x kLd: streamed queries
  float* g_s = q_s + kTile * kLd;  // kTile x kLd: streamed dO
  float* p_s = g_s + kTile * kLd;  // kRows x kTile: P^T, rounded
  float* ds_s = p_s + kRows * kTile;  // kRows x kTile: dS^T, rounded
  zero_padding<DH>(smem, Tiles::kSmemDkv);

  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ql = lane;  // the query of the tile this lane scores
  const int D = H * DH;
  const long long head_off = (long long)b * S * row_stride + (long long)h * DH;
  const long long dout_off = (long long)b * S * D + (long long)h * DH;
  const long long stat_off = ((long long)b * H + h) * S;
  const uint8_t* key_mask = mask ? mask + (long long)b * S : nullptr;
  const float inv_s = 1.f / (float)S;

  load_tile<T, DH, kLd>(k_s, k + head_off, row_stride, k0, kRows, S);
  load_tile<T, DH, kLd>(v_s, v + head_off, row_stride, k0, kRows, S);

  bool key_in[kRowsPerWarp];
  float key_bias[kRowsPerWarp];
  float dk_acc[kRowsPerWarp][kCols], dv_acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int key = k0 + warp * kRowsPerWarp + r;
    key_in[r] = key < S;
    key_bias[r] = (key_in[r] && key_mask && !key_mask[key]) ? kMaskBias : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  }
  const float* k_w = k_s + warp * kRowsPerWarp * kLd;
  const float* v_w = v_s + warp * kRowsPerWarp * kLd;
  float* p_w = p_s + warp * kRowsPerWarp * kTile;
  float* ds_w = ds_s + warp * kRowsPerWarp * kTile;

  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();  // the previous Q and dO tiles are consumed (and K, V are in)
    load_tile<T, DH, kLd>(q_s, q + head_off, row_stride, q0, kTile, S);
    load_tile<T, DH, kLd>(g_s, dout + dout_off, D, q0, kTile, S);
    __syncthreads();

    // scores^T and dP^T of this warp's keys against query q0 + ql
    const int row = q0 + ql;
    const bool in_q = row < S;
    const float row_lse = in_q ? lse[stat_off + row] : 0.f;
    const float row_delta = in_q ? delta[stat_off + row] : 0.f;
    float sc[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = dp[r] = 0.f;
    const float* q_l = q_s + ql * kLd;
    const float* g_l = g_s + ql * kLd;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 qa = ld4(q_l + d);
      const float4 ga = ld4(g_l + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        sc[r] = dot4(ld4(k_w + r * kLd + d), qa, sc[r]);
        dp[r] = dot4(ld4(v_w + r * kLd + d), ga, dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float p = prob(sc[r] * scale, key_bias[r], row_lse, in_q && key_in[r], inv_s);
      float pd = p, d = dp[r];
      if constexpr (DROPOUT) {
        const int key = k0 + warp * kRowsPerWarp + r;
        const bool kept = in_q && key_in[r] && keep[(stat_off + row) * S + key];
        pd = kept ? p * inv_keep : 0.f;
        d = kept ? d * inv_keep : 0.f;
      }
      p_w[r * kTile + ql] = round_to(pd, T());
      ds_w[r * kTile + ql] = round_to(p * (d - row_delta), T());
    }
    __syncwarp();

    // dV += P^T dO, dK += dS^T Q
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float pt[kRowsPerWarp][4], dst[kRowsPerWarp][4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 x = ld4(p_w + r * kTile + j);
        const float4 y = ld4(ds_w + r * kTile + j);
        pt[r][0] = x.x;
        pt[r][1] = x.y;
        pt[r][2] = x.z;
        pt[r][3] = x.w;
        dst[r][0] = y.x;
        dst[r][1] = y.y;
        dst[r][2] = y.z;
        dst[r][3] = y.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* g_row = g_s + (j + jj) * kLd + lane;
        const float* q_row = q_s + (j + jj) * kLd + lane;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float gg = g_row[32 * c];
          const float qq = q_row[32 * c];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            dv_acc[r][c] = fmaf(pt[r][jj], gg, dv_acc[r][c]);
            dk_acc[r][c] = fmaf(dst[r][jj], qq, dk_acc[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int key = k0 + warp * kRowsPerWarp + r;
    if (key >= S) continue;
    const long long off = ((long long)b * S + key) * grad_stride + (long long)h * DH + lane;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (DH % 32 == 0 || lane + 32 * c < DH) {
        store(dk + off + 32 * c, dk_acc[r][c] * scale);
        store(dv + off + 32 * c, dv_acc[r][c]);
      }
    }
  }
}

template <typename T, int DH, bool DROPOUT>
cudaError_t launch(const void* q, const void* k, const void* v, long long row_stride,
                   const void* mask, const void* keep, float inv_keep, const void* out,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, long long grad_stride, int B, int S, int H, cudaStream_t stream) {
  using Tiles = BwdTiles<DH>;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<T, DH, DROPOUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tiles::kSmemDq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<T, DH, DROPOUT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Tiles::kSmemDkv);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)DH));  // rounded once, as 1.0 / dh**0.5 is
  const T* q_t = static_cast<const T*>(q);
  const T* k_t = static_cast<const T*>(k);
  const T* v_t = static_cast<const T*>(v);
  const T* dout_t = static_cast<const T*>(dout);
  const uint8_t* mask_t = static_cast<const uint8_t*>(mask);
  const uint8_t* keep_t = static_cast<const uint8_t*>(keep);

  const long long rows = (long long)B * S;
  attention_bwd_delta_kernel<T><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      static_cast<const T*>(out), dout_t, delta, B, S, H, DH);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((S + Tiles::kRows - 1) / Tiles::kRows, H, B);
  attention_bwd_dq_kernel<T, DH, DROPOUT><<<grid, kThreads, Tiles::kSmemDq, stream>>>(
      q_t, k_t, v_t, row_stride, mask_t, keep_t, inv_keep, dout_t, lse, delta,
      static_cast<T*>(dq), grad_stride, S, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  attention_bwd_dkv_kernel<T, DH, DROPOUT><<<grid, kThreads, Tiles::kSmemDkv, stream>>>(
      q_t, k_t, v_t, row_stride, mask_t, keep_t, inv_keep, dout_t, lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), grad_stride, S, H, scale);
  return cudaGetLastError();
}

// The head dims a library holds instances of (MMU_BWD_PLAIN_DIMS and
// MMU_BWD_DROPOUT_DIMS, either list may be empty; MMU_BWD_BF16_PLAIN_DIMS, by
// default the plain list, leaves out of the bf16 instances a head dim whose
// bf16 backward another source runs).
#ifndef MMU_BWD_BF16_PLAIN_DIMS
#define MMU_BWD_BF16_PLAIN_DIMS MMU_BWD_PLAIN_DIMS
#endif

template <int... DHS>
struct Dims {};

// The launches of the instance whose head dim is dh, among DHS; an invalid
// value when this library has none.
template <typename T, bool DROPOUT, int... DHS>
cudaError_t dispatch(Dims<DHS...>, int dh, const void* q, const void* k, const void* v,
                     long long row_stride, const void* mask, const void* keep, float inv_keep,
                     const void* out, const void* dout, const float* lse, float* delta,
                     void* dq, void* dk, void* dv, long long grad_stride, int B, int S, int H,
                     cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((dh == DHS &&
          ((err = launch<T, DHS, DROPOUT>(q, k, v, row_stride, mask, keep, inv_keep, out, dout,
                                          lse, delta, dq, dk, dv, grad_stride, B, S, H, stream)),
           true)) || ...);
  return err;
}

template <typename T>
cudaError_t dispatch_all(int dh, const void* q, const void* k, const void* v,
                         long long row_stride, const void* mask, const void* keep,
                         float inv_keep, const void* out, const void* dout, const float* lse,
                         float* delta, void* dq, void* dk, void* dv, long long grad_stride,
                         int B, int S, int H, cudaStream_t stream) {
  if (keep != nullptr) {
    return dispatch<T, true>(Dims<MMU_BWD_DROPOUT_DIMS>(), dh, q, k, v, row_stride, mask, keep,
                             inv_keep, out, dout, lse, delta, dq, dk, dv, grad_stride, B, S, H,
                             stream);
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return dispatch<T, false>(Dims<MMU_BWD_BF16_PLAIN_DIMS>(), dh, q, k, v, row_stride, mask,
                              nullptr, 1.f, out, dout, lse, delta, dq, dk, dv, grad_stride, B, S,
                              H, stream);
  } else {
    return dispatch<T, false>(Dims<MMU_BWD_PLAIN_DIMS>(), dh, q, k, v, row_stride, mask,
                              nullptr, 1.f, out, dout, lse, delta, dq, dk, dv, grad_stride, B, S,
                              H, stream);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// q, k, v: (B, S, D) views with row stride row_stride; mask: (B, S) bytes,
// nonzero = key kept, or NULL for all kept; keep: the forward's (B, H, S, S)
// dropout bytes with its inv_keep, or NULL for no dropout; out, dout: dense (B, S, D);
// lse: (B, H, S) float32 from the forward; delta: (B, H, S) float32 scratch;
// dq, dk, dv: (B, S, D) views with row stride grad_stride. Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for a head dim this
// library has no instance of).
extern "C" int mmu_attention_bwd(const void* q, const void* k, const void* v,
                                 long long row_stride, const void* mask, const void* keep,
                                 float inv_keep, const void* out,
                                 const void* dout, const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, long long grad_stride, int B, int S, int H,
                                 int dh, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = dispatch_all<float>(dh, q, k, v, row_stride, mask, keep, inv_keep, out, dout, lse_f,
                              delta_f, dq, dk, dv, grad_stride, B, S, H, st);
  } else if (dtype == 1) {
    err = dispatch_all<__nv_bfloat16>(dh, q, k, v, row_stride, mask, keep, inv_keep, out, dout,
                                      lse_f, delta_f, dq, dk, dv, grad_stride, B, S, H, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
