// Masked multi-head attention forward for Hopper (sm_90a) in bf16 on the FMA
// units, at Dh 32 and 128, and with dropout at Dh 32.
//
// The kernel template and its C entry point. Each attention_fwd*.cu file
// defines its lists of head dims (MMU_FWD_BF16_PLAIN_DIMS and
// MMU_FWD_BF16_DROPOUT_DIMS) before including this header, so the instances
// compile in separate nvcc processes, started together (ops/_build.py), and
// each library holds the head dims it names:
//   * attention_fwd.cu       Dh 32 and 128, and the dropout instance at 32
//                            (the tiny BERT's).
// fp32 at Dh 24-192, with and without dropout, runs as split fp32 on the
// tensor cores (attention_fwd_tc32.cuh). The wide head dims (256, 384, 768)
// have a kernel of their own on register micro-tiles and thread-block
// clusters, attention_fwd_wide.cuh (instances attention_fwd_256.cu,
// attention_fwd_wide.cu), which does not include this header; bf16 at Dh 24,
// 48, 64, 96, 192, 256, 384 and 768 without dropout, and at Dh 64 with it,
// runs on the tensor cores, attention_fwd_tc.cuh and attention_fwd_tc_wide.cuh.
//
// Replaces these Pallas TPU kernels of multimodal_uncertainty_tpu/ops/attention.py:
//   * _sdpa_packed_fwd_impl (body _attn_kernel_hl): whole-sequence attention
//     read straight off the packed (B, S, 3D) QKV projection;
//   * _sdpa_hl_fwd_impl (the same body): whole-sequence attention on separate
//     heads-last q, k, v (BERT's self-attention, Dh=64, two heads lane-masked
//     into one 128-lane block: a TPU layout device, not another function);
//   * _sdpa_flash_fwd_impl (body _attn_kernel_flash_fwd): the key-blocked
//     online-softmax forward that also emits the per-row log-sum-exp;
//   * _sdpa_hl_drop_fwd_impl (body _attn_kernel_hl_drop): the heads-last
//     forward with dropout on the attention probabilities, from a uint8
//     (B, H, S, S) keep mask drawn outside the kernel (the DROPOUT instances);
//   * _sdpa_pallas_fwd_impl (body _attn_kernel): the heads-first (B, H, S, Dh)
//     forward the TPU takes for head dims that are neither a multiple nor a
//     divisor of 128 (Dh 24, 48, 96, 192 at D=768). Its (B, S, D) -> (B, H, S,
//     Dh) relayout has no counterpart here: every instance reads heads-last
//     rows through a row stride;
//   * _sdpa_flash_fwd_stream_impl :1488 (body _attn_kernel_flash_fwd_stream
//     :1318): the long-context forward (K4, reached through attention_flash)
//     that streams key tiles from HBM with nothing of the sequence resident.
//     Here every instance streams key tiles from device memory at any S
//     (64-bit offsets); K4 itself runs attention_fwd_tc.cu in bf16 and
//     attention_fwd_tc32.cuh in fp32.
// The TPU needed the flash kernel because the whole-sequence score plane
// stops fitting VMEM past S = 574 (packed, Dh=256) or S = 523 (heads-last,
// Dh=64) at fp32. This kernel tiles the keys through shared memory with an
// online softmax, so one kernel covers every S.
//
// Per (batch, head):  out = softmax_fp32(q k^T * (1/sqrt(Dh)) + bias) v
// with bias = 0 for kept keys and the finite -1e30 for masked ones. A row
// whose keys are all masked therefore averages V uniformly over all S keys,
// as the JAX reference does (no NaN, no zero). Logits and P.V accumulate in
// fp32; P is rounded to the input dtype before P.V, as in the TPU kernels.
// lse (optional) is m + log(l) per row, laid out (B, H, S) in fp32.
//
// Dropout (DROPOUT = true; bf16 at Dh 32 here): P is normalised before dropout, as
// in _attn_kernel_hl_drop, so the row sum l and the written LSE stay
// un-dropped; only the P.V accumulator takes keep ? e * inv_keep : 0, with
// inv_keep = 1 / (1 - rate). The keep byte of (row, key) sits beside the
// score: the 32 lanes of a warp read 32 neighbouring keys of one row, one
// coalesced load. The mask adds B*H*S^2 bytes: 103 MB at B=32, S=517, about
// 0.03 ms at 3.35 TB/s beside the forward's 0.39 ms bound of fp32 FMAs. With
// DROPOUT = false the template compiles to the code of the plain instances.
//
// Layout: q, k and v are read through a base pointer and a row stride, so the
// packed (B, S, 3D) projection (row stride 3D, k at column D, v at 2D) and
// separate (B, S, D) tensors take the same path with no copy.
// The output is (B, S, D), heads last.
//
// What bounds it: at FLAVA's serving shape (B=32, S=320, D=768) the forward
// does 4*B*S^2*D flops over 4*B*S*D*itemsize bytes, about 160 flops per
// byte in bf16: compute-bound on the card's FMA units.
// The design keeps the FMA units fed from shared memory: each warp owns 4
// query rows, each lane 2 keys of a 64-key tile for q.k and ceil(Dh/32)
// output columns for P.V, so one shared-memory load feeds 4-8 FMAs and a
// query row's softmax state never leaves its warp. At MMBT's shape (B=32,
// S=165, D=768, Dh=64) it is S/2 ~ 82 flops per byte, still past the FMA
// units' ridge of ~20; a block takes 33.5 KB there, so several share an SM.
//
// bf16 here runs on the fp32 FMA units (operands widened to fp32 in shared
// memory), at the fp32 rate. bf16 at Dh 64 without dropout (K4 fwd, K1/K2/K3
// fwd at 12 x 64; with dropout, K5), K6's 24, 48, 96 and 192 and FLAVA's 256,
// 384 and 768 run on the tensor cores instead, attention_fwd_tc.cuh and
// attention_fwd_tc_wide.cuh (wgmma); attention_fwd.cu leaves those instances
// out and ops/attention.py::fwd_source never routes them here. Still on the
// FMA units in bf16: Dh 32, 128 and the tiny BERT's Dh 32 dropout instance.
// Left for later: the tensor-core design for those, TMA / cp.async
// double-buffering of the K and V tiles, and a persistent grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;                 // 8 warps
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = (kThreads / 32) * kRowsPerWarp;  // 32 query rows a block
constexpr int kPad = 4;                       // floats of row padding (bank spread)
constexpr float kMaskBias = -1e30f;           // ops/attention.py NEG_INF

// The tiling of one head dim.
template <int DH>
struct FwdTiles {
  static_assert(DH % 32 == 0, "a lane owns whole 32-column groups of the output");
  static_assert(DH <= 192, "the wide head dims are attention_fwd_wide.cuh's");
  static constexpr int kBK = 64;                  // keys per shared-memory tile
  static constexpr int kKeys = kBK / 32;          // keys a lane scores
  static constexpr int kCols = DH / 32;           // output columns a lane owns
  static constexpr int kLd = 32 * kCols + kPad;   // floats a tile row takes
  static constexpr int kSmem = ((kBQ + kBK) * kLd + kBQ * kBK) * (int)sizeof(float);
};

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

__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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

// Copy rows [row0, row0 + rows) of one head (DH values a row) into a float
// tile with row stride LD; rows at or past S are zero-filled. The row's
// padding (columns DH..LD) is left as it is: nothing reads it.
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

template <typename T, int DH, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     long long row_stride, const uint8_t* __restrict__ mask,
                     const uint8_t* __restrict__ keep, float inv_keep,
                     T* __restrict__ out, float* __restrict__ lse, int S, int H, float scale) {
  using Tiles = FwdTiles<DH>;
  constexpr int kBK = Tiles::kBK;
  constexpr int kKeys = Tiles::kKeys;
  constexpr int kCols = Tiles::kCols;
  constexpr int kLd = Tiles::kLd;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;               // kBQ x kLd
  float* kv_s = q_s + kBQ * kLd;   // kBK x kLd: the K tile, then the V tile
  float* p_s = kv_s + kBK * kLd;   // kBQ x kBK

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long head_off = (long long)b * S * row_stride + (long long)h * DH;
  const uint8_t* key_mask = mask ? mask + (long long)b * S : nullptr;

  load_tile<T, DH, kLd>(q_s, q + head_off, row_stride, q0, kBQ, S);

  const float* q_w = q_s + warp * kRowsPerWarp * kLd;
  float* p_w = p_s + warp * kRowsPerWarp * kBK;
  float acc[kRowsPerWarp][kCols];
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // the previous V tile is consumed (and the Q tile is in)
    load_tile<T, DH, kLd>(kv_s, k + head_off, row_stride, k0, kBK, S);
    __syncthreads();

    // scores of this warp's 4 rows against keys k0 + lane + 32 j
    float sc[kRowsPerWarp][kKeys];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j) sc[r][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 kx[kKeys];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kx[j] = ld4(kv_s + (lane + 32 * j) * kLd + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = ld4(q_w + r * kLd + d);
#pragma unroll
        for (int j = 0; j < kKeys; ++j) sc[r][j] = dot4(qv, kx[j], sc[r][j]);
      }
    }

    // online softmax; keys past S do not exist (weight exactly 0), masked
    // keys are the finite -1e30 like any other score
    bool in_k[kKeys];
    float bias[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int key = k0 + lane + 32 * j;
      in_k[j] = key < S;
      bias[j] = (in_k[j] && key_mask && !key_mask[key]) ? kMaskBias : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float s[kKeys];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        s[j] = in_k[j] ? sc[r][j] * scale + bias[j] : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m_run[r], warp_max(mx));
      const float alpha = expf(m_run[r] - m_new);  // 0 on the first tile
      float e[kKeys];
      float e_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        e[j] = expf(s[j] - m_new);
        e_sum += e[j];
      }
      l_run[r] = l_run[r] * alpha + warp_sum(e_sum);
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        float pv = e[j];  // the weight P.V takes
        if constexpr (DROPOUT) {
          const int row = q0 + warp * kRowsPerWarp + r;
          const uint8_t* keep_row = keep + (((long long)b * H + h) * S + row) * S;
          pv = (row < S && in_k[j] && keep_row[k0 + lane + 32 * j]) ? e[j] * inv_keep : 0.f;
        }
        p_w[r * kBK + lane + 32 * j] = round_to(pv, T());
      }
    }

    __syncthreads();  // every warp is done with the K tile
    load_tile<T, DH, kLd>(kv_s, v + head_off, row_stride, k0, kBK, S);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float p[kRowsPerWarp][4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pv = ld4(p_w + r * kBK + j);
        p[r][0] = pv.x;
        p[r][1] = pv.y;
        p[r][2] = pv.z;
        p[r][3] = pv.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* v_row = kv_s + (j + jj) * kLd + lane;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float vv = v_row[32 * c];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fmaf(p[r][jj], vv, acc[r][c]);
        }
      }
    }
  }

  const int D = H * DH;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= S) continue;
    const float inv_l = 1.f / l_run[r];
    T* o_row = out + ((long long)b * S + row) * D + (long long)h * DH + lane;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      store(o_row + 32 * c, acc[r][c] * inv_l);
    }
    if (lse != nullptr && lane == 0) {
      lse[((long long)b * H + h) * S + row] = m_run[r] + logf(l_run[r]);
    }
  }
}

template <typename T, int DH, bool DROPOUT>
cudaError_t launch(const void* q, const void* k, const void* v, long long row_stride,
                   const void* mask, const void* keep, float inv_keep, void* out, float* lse,
                   int B, int S, int H, cudaStream_t stream) {
  constexpr int smem = FwdTiles<DH>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, DH, DROPOUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  attention_fwd_kernel<T, DH, DROPOUT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), row_stride,
      static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(keep), inv_keep,
      static_cast<T*>(out), lse, S, H,
      (float)(1.0 / sqrt((double)DH)));  // rounded once, as 1.0 / dh**0.5 is
  return cudaGetLastError();
}

// The head dims a library holds instances of (any list may be empty).
template <int... DHS>
struct Dims {};

// The launch of the instance whose head dim is dh, among DHS; an invalid
// value when this library has none.
template <typename T, bool DROPOUT, int... DHS>
cudaError_t dispatch(Dims<DHS...>, int dh, const void* q, const void* k, const void* v,
                     long long row_stride, const void* mask, const void* keep, float inv_keep,
                     void* out, float* lse, int B, int S, int H, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((dh == DHS && ((err = launch<T, DHS, DROPOUT>(q, k, v, row_stride, mask, keep,
                                                       inv_keep, out, lse, B, S, H, stream)),
                        true)) || ...);
  return err;
}

}  // namespace

// Plain C entry point (loaded with ctypes): bf16 only (dtype 1; fp32 runs
// attention_fwd_tc32.cuh). mask: (B, S) bytes, nonzero = key kept, or NULL
// for all kept. keep: (B, H, S, S) bytes of the dropout mask, nonzero =
// probability kept and scaled by inv_keep, or NULL for no dropout. lse: (B,
// H, S) float32 or NULL. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a dtype or head dim this library has no
// instance of).
extern "C" int mmu_attention_fwd(const void* q, const void* k, const void* v,
                                 long long row_stride, const void* mask, const void* keep,
                                 float inv_keep, void* out, void* lse, int B, int S, int H,
                                 int dh, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using T = __nv_bfloat16;
  if (keep != nullptr)
    return (int)dispatch<T, true>(Dims<MMU_FWD_BF16_DROPOUT_DIMS>(), dh, q, k, v, row_stride,
                                  mask, keep, inv_keep, out, lse_f, B, S, H, st);
  return (int)dispatch<T, false>(Dims<MMU_FWD_BF16_PLAIN_DIMS>(), dh, q, k, v, row_stride, mask,
                                 nullptr, 1.f, out, lse_f, B, S, H, st);
}
