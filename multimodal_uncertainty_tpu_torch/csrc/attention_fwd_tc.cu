// Masked multi-head attention forward for Hopper (sm_90a) in bf16 at Dh=64,
// without dropout, on the tensor cores.
//
// Replaces these Pallas TPU kernels of multimodal_uncertainty_tpu/ops/attention.py
// in bf16 at 64-wide heads (attention_fwd.cuh keeps every other dtype, head
// dim and the dropout instances):
//   * _sdpa_flash_fwd_stream_impl :1488 (body _attn_kernel_flash_fwd_stream
//     :1318): the long-context forward (K4, reached through attention_flash);
//   * _sdpa_packed_fwd_impl :777, _sdpa_flash_fwd_impl :1071 and
//     _sdpa_hl_fwd_impl :419 (K1, K3, K2 fwd) at 12 heads of 64.
//
// Function and contract: those of attention_fwd.cuh, unchanged. Per (batch,
// head): out = softmax_fp32(q k^T / 8 + bias) v, with bias = 0 for kept keys
// and the finite -1e30 for masked ones, so a row whose keys are all masked
// averages V uniformly over all S keys; keys past S (the ragged last tile)
// weigh exactly 0. Logits and P.V sum in fp32; the unnormalised P is rounded
// to bf16 before P.V, the row sum l is taken before that rounding (the SIMT
// kernel's policy). lse = m + ln(l) per row, (B, H, S) fp32 in natural log;
// a fully masked row writes exactly -1e30 (what the plain version and the
// SIMT kernel give, m + ln(S) rounding to m), which both backwards read as
// "uniform row" (lse <= -5e29). q, k, v are read through base pointers with
// one row stride (the packed (B, S, 3D) projection in place); out is dense
// (B, S, D); 64-bit offsets, any S with no padding.
//
// What bounds it: 4 B S^2 D flops on the bf16 tensor cores and one exp2 per
// score on the SFU. At K4's row (B=1, S=16384, 12 x 64) that is 825 GFLOP,
// 0.83 ms at 989 TFLOP/s, and 3.2e9 exponentials, ~0.9 ms at the SFU's 16 a
// clock per SM; the bytes (~0.03 ms) do not count. Measured on an H100 80GB
// HBM3 at 700 W: 2.7 ms there (305 TFLOP/s of useful work).
//
// Design (FA2's forward on Hopper's warpgroup products, from the pieces it
// shares with attention_bwd_tc.cuh in attention_tc.cuh):
//   * a block is two warpgroups owning 128 query rows, 64 each (16 a warp).
//     A warpgroup loads its q rows once from device memory straight into
//     registers, as the A fragments of wgmma's register-A form, for the whole
//     loop;
//   * K and V come in 64-row tiles of 8 KB through a two-stage cp.async ring,
//     rows past S zero-filled by the copy, in the 128-byte swizzle that wgmma
//     reads through a shared-memory descriptor. The K tile is a K-major B
//     operand (S = q k^T: n = key, k = Dh), the V tile an MN-major one
//     (O += P v: k = key, n = Dh);
//   * S goes into fp32 accumulators; the online softmax runs on them in the
//     exp2 domain (scale and log2(e) folded into one FMA with the key's bias:
//     0, the masked -1e30 log2(e), or -inf past S), the row max and the
//     rescale factor shared by the four threads of a row through two
//     shuffles; the row sum stays a per-thread partial until the end. P,
//     rounded to bf16, goes straight back as the register-A operand of
//     O += P v (the accumulator layout is the register-A layout): P never
//     touches shared memory.
// Left for later: TMA and a deeper ring, overlapping one tile's softmax with
// the other warpgroup's products (FA3's ping-pong), one producer warp.
#include "attention_tc.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kScaleLog2 = 0.125f * kLog2e;  // 1 / sqrt(64) in the exp2 domain
constexpr float kMaskBias2 = kMaskBias * kLog2e;

// The max of x over the four threads of a row (lanes 4 g .. 4 g + 3).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The kRows query rows of one (batch, head), looping over key tiles.
__global__ void __launch_bounds__(kThreads, 2)
attention_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, long long row_stride,
                        const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                        float* __restrict__ lse, int S, int H) {
  __shared__ __align__(1024) uint8_t tiles[2][2][kTileBytes];  // [stage][k, v]
  // [stage][key]: the key's exponent bias in the exp2 domain: 0 if kept, the
  // masked -1e30 log2(e), -inf past S
  __shared__ float kbias[2][kTile];

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int D = H * kDh;
  const long long head_off = (long long)b * S * row_stride + (long long)h * kDh;
  const uint8_t* key_mask = mask ? mask + (long long)b * S : nullptr;

  auto prefetch = [&](int stage, int k0) {
    load_tile(smem_u32(tiles[stage][0]), k + head_off, row_stride, k0, S);
    load_tile(smem_u32(tiles[stage][1]), v + head_off, row_stride, k0, S);
    if (threadIdx.x < kTile) {
      const int key = k0 + threadIdx.x;
      kbias[stage][threadIdx.x] =
          key >= S ? -INFINITY : (key_mask && !key_mask[key] ? kMaskBias2 : 0.f);
    }
    cp_async_commit();
  };
  prefetch(0, 0);

  const int lo = q0 + warp * 16 + g, hi = lo + 8;
  uint32_t qa[4][4];
  load_a(qa, q + head_off, row_stride, lo, hi, S, t4);

  // per row (lo, hi): the running max (exp2 domain) and this thread's part of
  // the running sum (its 16 of the tile's 64 columns)
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[8][4];
  zero(acc);
  const int n_tiles = (S + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      prefetch(stage ^ 1, (it + 1) * kTile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t ks = smem_u32(tiles[stage][0]), vs = smem_u32(tiles[stage][1]);

    float sc[8][4];
    zero(sc);
    wgmma_fence();
    times_tile_rows(sc, qa, ks);  // S = q k^T
    wgmma_commit();
    fence(sc);
    wgmma_wait();
    fence(sc);

    // logits in the exp2 domain, the tile's row max, the rescale of the old state
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = fmaf(sc[j][e], kScaleLog2, kbias[stage][8 * j + 2 * t4 + (e & 1)]);
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]));  // finite: every tile has a key < S
      alpha[r] = ex2(m_run[r] - m_new);                       // 0 on the first tile
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(sc[j][e] - m_run[e >> 1]);
        sc[j][e] = p;
        rs[e >> 1] += p;
        acc[j][e] *= alpha[e >> 1];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = fmaf(l_run[r], alpha[r], rs[r]);

    uint32_t pa[4][4];
    to_a(sc, pa);  // the unnormalised P, rounded to bf16
    wgmma_fence();
    times_tile(acc, pa, vs);  // O += P v
    wgmma_commit();
    fence(acc);
    wgmma_wait();  // the tiles are read: the next prefetch may overwrite them
    fence(acc);
    __syncthreads();
  }

  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] = quad_sum(l_run[r]);
    inv_l[r] = 1.f / l_run[r];
  }
  bf16* o = out + (long long)b * S * D + (long long)h * kDh;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (lo < S)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)lo * D + col) =
          __floats2bfloat162_rn(acc[j][0] * inv_l[0], acc[j][1] * inv_l[0]);
    if (hi < S)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)hi * D + col) =
          __floats2bfloat162_rn(acc[j][2] * inv_l[1], acc[j][3] * inv_l[1]);
  }
  if (lse != nullptr && t4 == 0) {
    const long long stat_off = ((long long)b * H + h) * S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? hi : lo;
      // a fully masked row (its max is the masked bias) is -1e30 + ln(S) = -1e30 in fp32
      if (row < S)
        lse[stat_off + row] = m_run[r] <= 0.5f * kMaskBias2 ? kMaskBias
                                                            : m_run[r] * kLn2 + logf(l_run[r]);
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes); bf16 only, Dh = 64, no dropout.
// q, k, v: (B, S, H * 64) views with row stride row_stride (a multiple of 8
// elements, 16-byte aligned bases); mask: (B, S) bytes, nonzero = key kept, or
// NULL for all kept; out: dense (B, S, H * 64) bf16; lse: (B, H, S) float32
// or NULL. Returns the cudaError_t of the launch.
extern "C" int mmu_attention_fwd_tc(const void* q, const void* k, const void* v,
                                    long long row_stride, const void* mask, void* out,
                                    void* lse, int B, int S, int H, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || S < 1 || H < 1 || row_stride % 8) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  attention_fwd_tc_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      row_stride, static_cast<const uint8_t*>(mask), static_cast<bf16*>(out),
      static_cast<float*>(lse), S, H);
  return (int)cudaGetLastError();
}
