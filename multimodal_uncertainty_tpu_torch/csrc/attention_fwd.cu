// Masked multi-head attention forward for Hopper (sm_90a), fp32 and bf16.
//
// Replaces three Pallas TPU kernels of multimodal_uncertainty_tpu/ops/attention.py:
//   * _sdpa_packed_fwd_impl (body _attn_kernel_hl): whole-sequence attention
//     read straight off the packed (B, S, 3D) QKV projection;
//   * _sdpa_hl_fwd_impl (the same body): whole-sequence attention on separate
//     heads-last q, k, v (BERT's self-attention, Dh=64, two heads lane-masked
//     into one 128-lane block: a TPU layout device, not another function);
//   * _sdpa_flash_fwd_impl (body _attn_kernel_flash_fwd): the key-blocked
//     online-softmax forward that also emits the per-row log-sum-exp;
//   * _sdpa_hl_drop_fwd_impl (body _attn_kernel_hl_drop): the heads-last
//     forward with dropout on the attention probabilities, from a uint8
//     (B, H, S, S) keep mask drawn outside the kernel (the DROPOUT instances).
// The TPU needed the flash kernel because the whole-sequence score plane
// stops fitting VMEM past S = 574 (packed, Dh=256) or S = 523 (heads-last,
// Dh=64) at fp32. This kernel tiles the keys through shared memory with an
// online softmax, so one kernel covers every S. Head dims: 32, 64, 128, 256.
//
// Per (batch, head):  out = softmax_fp32(q k^T * (1/sqrt(Dh)) + bias) v
// with bias = 0 for kept keys and the finite -1e30 for masked ones. A row
// whose keys are all masked therefore averages V uniformly over all S keys,
// as the JAX reference does (no NaN, no zero). Logits and P.V accumulate in
// fp32; P is rounded to the input dtype before P.V, as in the TPU kernels.
// lse (optional) is m + log(l) per row, laid out (B, H, S) in fp32.
//
// Dropout (DROPOUT = true, Dh 32 and 64): P is normalised before dropout, as
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
// separate (B, S, D) tensors (row stride D) take the same path with no copy.
// The output is (B, S, D), heads last.
//
// What bounds it: at the serving shape (B=32, S=320, D=768, Dh=256) the
// forward does 4*B*S^2*D flops over 4*B*S*D*itemsize bytes, about 80 flops
// per byte in fp32: compute-bound on the card's FMA units (fp32 stays fp32,
// no TF32). The design keeps the FMA units fed from shared memory: each warp
// owns 4 query rows, each lane 2 keys of a 64-key tile for q.k and
// Dh/32 output columns for P.V, so one shared-memory load feeds 4-8 FMAs and
// a query row's softmax state never leaves its warp. Q, one K-or-V tile and
// P share ~105 KB at Dh=256, which lets two blocks share an SM to hide the
// unpipelined tile loads. At MMBT's shape (B=32, S=165, D=768, Dh=64) it is
// S/4 ~ 41 flops per byte, still past fp32's ridge of ~20; a block takes
// 33.5 KB there, so several share an SM. Left for later: bf16 on the tensor cores (wgmma),
// TMA / cp.async double-buffering of the K and V tiles, and a persistent grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = (kThreads / 32) * kRowsPerWarp;  // 32 query rows a block
constexpr int kBK = 64;                       // keys per shared-memory tile
constexpr int kPad = 4;                       // floats of row padding (bank spread)
constexpr float kMaskBias = -1e30f;           // ops/attention.py NEG_INF

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

__device__ __forceinline__ float round_to(float x, float) { return x; }
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

// Copy rows [row0, row0 + rows) of one head (DH values a row) into a float
// tile with row stride DH + kPad; rows at or past S are zero-filled.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* tile, const T* base, long long row_stride,
                                          int row0, int rows, int S) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kVecPerRow = DH / kVec;
  for (int i = threadIdx.x; i < rows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    float* dst = tile + r * (DH + kPad) + c;
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
  constexpr int kLd = DH + kPad;
  constexpr int kCols = DH / 32;  // output columns a lane owns
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

  load_tile<T, DH>(q_s, q + head_off, row_stride, q0, kBQ, S);

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
    load_tile<T, DH>(kv_s, k + head_off, row_stride, k0, kBK, S);
    __syncthreads();

    // scores of this warp's 4 rows against keys k0 + lane and k0 + lane + 32
    float sc[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r][0] = sc[r][1] = 0.f;
    const float* k_a = kv_s + lane * kLd;
    const float* k_b = kv_s + (lane + 32) * kLd;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(k_a + d);
      const float4 kb = *reinterpret_cast<const float4*>(k_b + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_w + r * kLd + d);
        sc[r][0] = fmaf(qv.x, ka.x, sc[r][0]);
        sc[r][0] = fmaf(qv.y, ka.y, sc[r][0]);
        sc[r][0] = fmaf(qv.z, ka.z, sc[r][0]);
        sc[r][0] = fmaf(qv.w, ka.w, sc[r][0]);
        sc[r][1] = fmaf(qv.x, kb.x, sc[r][1]);
        sc[r][1] = fmaf(qv.y, kb.y, sc[r][1]);
        sc[r][1] = fmaf(qv.z, kb.z, sc[r][1]);
        sc[r][1] = fmaf(qv.w, kb.w, sc[r][1]);
      }
    }

    // online softmax; keys past S do not exist (weight exactly 0), masked
    // keys are the finite -1e30 like any other score
    const int ka_idx = k0 + lane, kb_idx = k0 + lane + 32;
    const bool in_a = ka_idx < S, in_b = kb_idx < S;
    const float bias_a = (in_a && key_mask && !key_mask[ka_idx]) ? kMaskBias : 0.f;
    const float bias_b = (in_b && key_mask && !key_mask[kb_idx]) ? kMaskBias : 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float s_a = in_a ? sc[r][0] * scale + bias_a : -INFINITY;
      const float s_b = in_b ? sc[r][1] * scale + bias_b : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(fmaxf(s_a, s_b)));
      const float alpha = expf(m_run[r] - m_new);  // 0 on the first tile
      const float e_a = expf(s_a - m_new);
      const float e_b = expf(s_b - m_new);
      l_run[r] = l_run[r] * alpha + warp_sum(e_a + e_b);
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      float pv_a = e_a, pv_b = e_b;  // the weights P.V takes
      if constexpr (DROPOUT) {
        const int row = q0 + warp * kRowsPerWarp + r;
        const uint8_t* keep_row = keep + (((long long)b * H + h) * S + row) * S;
        pv_a = (row < S && in_a && keep_row[ka_idx]) ? e_a * inv_keep : 0.f;
        pv_b = (row < S && in_b && keep_row[kb_idx]) ? e_b * inv_keep : 0.f;
      }
      p_w[r * kBK + lane] = round_to(pv_a, T());
      p_w[r * kBK + lane + 32] = round_to(pv_b, T());
    }

    __syncthreads();  // every warp is done with the K tile
    load_tile<T, DH>(kv_s, v + head_off, row_stride, k0, kBK, S);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float p[kRowsPerWarp][4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(p_w + r * kBK + j);
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
    for (int c = 0; c < kCols; ++c) store(o_row + 32 * c, acc[r][c] * inv_l);
    if (lse != nullptr && lane == 0) {
      lse[((long long)b * H + h) * S + row] = m_run[r] + logf(l_run[r]);
    }
  }
}

template <typename T, int DH, bool DROPOUT>
cudaError_t launch(const void* q, const void* k, const void* v, long long row_stride,
                   const void* mask, const void* keep, float inv_keep, void* out, float* lse,
                   int B, int S, int H, cudaStream_t stream) {
  const int smem = ((kBQ + kBK) * (DH + kPad) + kBQ * kBK) * (int)sizeof(float);
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

// keep == NULL: the plain instances (Dh 32, 64, 128, 256); otherwise the
// dropout instances (Dh 32 and 64, BERT's head dims).
template <typename T>
cudaError_t dispatch(int dh, const void* q, const void* k, const void* v, long long row_stride,
                     const void* mask, const void* keep, float inv_keep, void* out, float* lse,
                     int B, int S, int H, cudaStream_t stream) {
  if (keep != nullptr) {
    switch (dh) {
      case 32: return launch<T, 32, true>(q, k, v, row_stride, mask, keep, inv_keep, out, lse,
                                          B, S, H, stream);
      case 64: return launch<T, 64, true>(q, k, v, row_stride, mask, keep, inv_keep, out, lse,
                                          B, S, H, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (dh) {
    case 32: return launch<T, 32, false>(q, k, v, row_stride, mask, nullptr, 1.f, out, lse,
                                         B, S, H, stream);
    case 64: return launch<T, 64, false>(q, k, v, row_stride, mask, nullptr, 1.f, out, lse,
                                         B, S, H, stream);
    case 128: return launch<T, 128, false>(q, k, v, row_stride, mask, nullptr, 1.f, out, lse,
                                           B, S, H, stream);
    case 256: return launch<T, 256, false>(q, k, v, row_stride, mask, nullptr, 1.f, out, lse,
                                           B, S, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// mask: (B, S) bytes, nonzero = key kept, or NULL for all kept. keep: (B, H,
// S, S) bytes of the dropout mask, nonzero = probability kept and scaled by
// inv_keep, or NULL for no dropout. lse: (B, H, S) float32 or NULL. Returns
// the cudaError_t of the launch.
extern "C" int mmu_attention_fwd(const void* q, const void* k, const void* v,
                                 long long row_stride, const void* mask, const void* keep,
                                 float inv_keep, void* out, void* lse, int B, int S, int H,
                                 int dh, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = dispatch<float>(dh, q, k, v, row_stride, mask, keep, inv_keep, out, lse_f, B, S, H,
                          st);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(dh, q, k, v, row_stride, mask, keep, inv_keep, out, lse_f, B,
                                  S, H, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
