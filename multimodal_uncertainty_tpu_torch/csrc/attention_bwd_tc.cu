// Masked multi-head attention backward for Hopper (sm_90a) in bf16 at Dh=64,
// without dropout, on the tensor cores.
//
// Replaces these Pallas TPU kernels of multimodal_uncertainty_tpu/ops/attention.py
// in bf16 at 64-wide heads (attention_bwd_wide.cuh keeps every other dtype,
// head dim and the dropout instances):
//   * _sdpa_flash_bwd_stream_impl :1521 (bodies _attn_kernel_flash_dq_stream
//     :1374 and _attn_kernel_flash_dkv_stream :1421): the long-context
//     backward (K4, reached through attention_flash);
//   * _sdpa_packed_bwd_impl :813, _sdpa_flash_bwd_impl :1219 and
//     _sdpa_hl_bwd_impl :504 (K1, K3, K2 bwd) at 12 heads of 64.
//
// Function and contract: those of attention_bwd_wide.cuh, unchanged. Three
// launches: delta = rowsum(dO * O) per (row, head); a dQ pass over query
// tiles looping over key tiles; a dK/dV pass over key tiles looping over
// query tiles. Each block owns its output rows (no atomics, deterministic).
// P = exp(s * scale + bias - lse) in fp32 from the forward's lse; masked keys
// take the finite -1e30 after the scaled product (so P = 0), keys past S in
// the ragged last tile weigh exactly 0, and a query row with lse <= -5e29
// (all its keys masked) takes P = 1/S, the gradient of the forward's uniform
// average. P (for P^T dO) and dS = P (dP - delta) (for dS K and dS^T Q) are
// rounded to bf16 before their products, as _attn_kernel_flash_dkv_stream
// does; every product sums in fp32. q, k, v are read through base pointers
// with one row stride (the packed (B, S, 3D) projection in place), dq, dk, dv
// written with their own; out and dout dense (B, S, D); lse and delta
// (B, H, S) fp32; 64-bit offsets, any S with no padding.
//
// What bounds it: 10 B S^2 D flops of useful work (JAX's CostEstimate) at the
// bf16 tensor rate; at B=1, S=16384, 12 x 64 that is 2.06 TFLOP, 2.08 ms at
// 989 TFLOP/s, against 0.05 ms for its bytes. Like the SIMT kernel this
// design recomputes S = q k^T and dP = dO v^T in both passes (14 B S^2 D flops
// executed) to keep each block's outputs in registers with no atomics.
//
// Design (FA2's backward on Hopper's warpgroup products, bf16 in, fp32 sums):
//   * a block is two warpgroups owning 128 rows, 64 each (16 a warp): query
//     rows in the dQ pass, key rows in the dK/dV pass. A warpgroup's own
//     operands (q and dO, or k and v) are loaded once from device memory
//     straight into registers, as the A fragments of wgmma's register-A form
//     (16 registers each), and stay there for the whole loop;
//   * the streamed operands (k and v, or q and dO) come in 64-row tiles of
//     8 KB through a two-stage cp.async ring, rows past S zero-filled by the
//     copy, stored in the 128-byte swizzle (16-byte chunk c of row r at c ^
//     (r % 8)), which wgmma reads through a shared-memory descriptor: an atom
//     of 8 rows of 128 bytes, the next 8 rows 1 KB on. The same tile serves
//     as a K-major B operand (S = q k^T: n = tile row, k = Dh; a k16 step
//     moves the descriptor 32 bytes) and as an MN-major one (dQ = dS k: k =
//     tile row, n = Dh; a k16 step moves it 2 KB);
//   * all five products are wgmma.m64n64k16 with A from registers: S (or
//     S^T = k q^T) and dP (or dP^T = v dO^T) into fp32 accumulators; P and dS
//     are formed there and, rounded to bf16, fed straight back as the A
//     fragments of dQ += dS k (or dV += P^T dO and dK += dS^T q): the
//     accumulator layout is the register-A layout, so S, P and dS never touch
//     shared memory. The per-element work is one FMA, one exp2 and a few adds:
//     masked and absent keys (and absent queries) carry -inf in the exponent,
//     fully masked rows add their 1/S.
// Left for later: TMA and a deeper ring, overlapping one tile's products with
// the next tile's softmax, one pass with atomics for dQ.
#include "attention_tc.cuh"

namespace {

constexpr float kScale = 0.125f;  // 1 / sqrt(64), exact

// Store a warp's 16 x 64 accumulator times `mul` as bf16 rows lo / hi (skipped past S).
__device__ __forceinline__ void store_rows(const float (&acc)[8][4], float mul, bf16* base,
                                           long long stride, int lo, int hi, int S, int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (lo < S)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)lo * stride + col) =
          __floats2bfloat162_rn(acc[j][0] * mul, acc[j][1] * mul);
    if (hi < S)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)hi * stride + col) =
          __floats2bfloat162_rn(acc[j][2] * mul, acc[j][3] * mul);
  }
}

// A key's exponent bias: 0 if kept, -inf if masked or past S (P = 0).
__device__ __forceinline__ float key_bias(const uint8_t* key_mask, int key, int S) {
  return key >= S || (key_mask && !key_mask[key]) ? -INFINITY : 0.f;
}

// A query row's -lse in the exp2 domain, -inf when the row is fully masked
// (lse <= -5e29: its P is the uniform 1/S, added apart) or past S.
__device__ __forceinline__ float neg_lse2(float lse, bool exists) {
  return exists && lse > 0.5f * kMaskBias ? -lse * kLog2e : -INFINITY;
}

// Pass 1: delta = rowsum(dO * O) per (row, head); one thread a (row, head).
__global__ void __launch_bounds__(256)
attention_bwd_tc_delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                              float* __restrict__ delta, long long rows, int S, int H) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // (b * S + s) * H + h
  if (i >= rows * H) return;
  const long long row = i / H;
  const int h = (int)(i % H);
  const uint4* o = reinterpret_cast<const uint4*>(out + i * kDh);
  const uint4* g = reinterpret_cast<const uint4*>(dout + i * kDh);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kDh / 8; ++c) {
    const uint4 a = o[c], b = g[c];
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[w]));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw[w]));
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  const long long b = row / S;
  delta[(b * H + h) * S + row % S] = acc;
}

// Pass 2: dQ for the kRows query rows of one (batch, head), looping over key tiles.
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_tc_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, long long row_stride,
                           const uint8_t* __restrict__ mask, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dq, long long grad_stride, int S, int H) {
  __shared__ __align__(1024) uint8_t tiles[2][2][kTileBytes];  // [stage][k, v]
  __shared__ float2 kinfo[2][kTile];  // [stage][key]: exponent bias, 1/S if it exists (else 0)

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int D = H * kDh;
  const long long head_off = (long long)b * S * row_stride + (long long)h * kDh;
  const long long dout_off = (long long)b * S * D + (long long)h * kDh;
  const long long stat_off = ((long long)b * H + h) * S;
  const uint8_t* key_mask = mask ? mask + (long long)b * S : nullptr;
  const float inv_s = 1.f / (float)S;

  auto prefetch = [&](int stage, int k0) {
    load_tile(smem_u32(tiles[stage][0]), k + head_off, row_stride, k0, S);
    load_tile(smem_u32(tiles[stage][1]), v + head_off, row_stride, k0, S);
    if (threadIdx.x < kTile) {
      const int key = k0 + threadIdx.x;
      kinfo[stage][threadIdx.x] = make_float2(key_bias(key_mask, key, S), key < S ? inv_s : 0.f);
    }
    cp_async_commit();
  };
  prefetch(0, 0);

  const int lo = q0 + warp * 16 + g, hi = lo + 8;
  uint32_t qa[4][4], ga[4][4];
  load_a(qa, q + head_off, row_stride, lo, hi, S, t4);
  load_a(ga, dout + dout_off, D, lo, hi, S, t4);
  float nlse[2], delta_r[2];
  bool uniform[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? hi : lo;
    const float l = row < S ? lse[stat_off + row] : 0.f;
    nlse[r] = neg_lse2(l, row < S);
    uniform[r] = row < S && l <= 0.5f * kMaskBias;
    delta_r[r] = row < S ? delta[stat_off + row] : 0.f;
  }

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

    float sc[8][4], dp[8][4];
    zero(sc);
    zero(dp);
    wgmma_fence();
    times_tile_rows(sc, qa, ks);  // S = q k^T
    times_tile_rows(dp, ga, vs);  // dP = dO v^T
    wgmma_commit();
    fence(sc);
    fence(dp);
    wgmma_wait();
    fence(sc);
    fence(dp);

    // dS = P (dP - delta) in place of dP
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float2 key = kinfo[stage][8 * j + 2 * t4 + (e & 1)];
        float p = ex2(fmaf(sc[j][e], kScale * kLog2e, nlse[r]) + key.x);
        if (uniform[r]) p = key.y;
        dp[j][e] = p * (dp[j][e] - delta_r[r]);
      }
    uint32_t dsa[4][4];
    to_a(dp, dsa);
    wgmma_fence();
    times_tile(acc, dsa, ks);  // dQ += dS k
    wgmma_commit();
    fence(acc);
    wgmma_wait();  // the tile is read: the next prefetch may overwrite it
    fence(acc);
    __syncthreads();
  }
  store_rows(acc, kScale, dq + (long long)b * S * grad_stride + (long long)h * kDh, grad_stride,
             lo, hi, S, t4);
}

// Pass 3: dK and dV for the kRows keys of one (batch, head), looping over query tiles.
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_tc_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, long long row_stride,
                            const uint8_t* __restrict__ mask, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, long long grad_stride,
                            int S, int H) {
  __shared__ __align__(1024) uint8_t tiles[2][2][kTileBytes];  // [stage][q, dO]
  // [stage][query]: -lse in the exp2 domain (-inf if fully masked or past S),
  // delta, 1/S if fully masked (else 0)
  __shared__ float4 qinfo[2][kTile];

  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int D = H * kDh;
  const long long head_off = (long long)b * S * row_stride + (long long)h * kDh;
  const long long dout_off = (long long)b * S * D + (long long)h * kDh;
  const long long stat_off = ((long long)b * H + h) * S;
  const uint8_t* key_mask = mask ? mask + (long long)b * S : nullptr;
  const float inv_s = 1.f / (float)S;

  auto prefetch = [&](int stage, int q0) {
    load_tile(smem_u32(tiles[stage][0]), q + head_off, row_stride, q0, S);
    load_tile(smem_u32(tiles[stage][1]), dout + dout_off, D, q0, S);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const float l = row < S ? lse[stat_off + row] : 0.f;
      const bool uniform = row < S && l <= 0.5f * kMaskBias;
      qinfo[stage][threadIdx.x] = make_float4(neg_lse2(l, row < S),
                                              row < S ? delta[stat_off + row] : 0.f,
                                              uniform ? inv_s : 0.f, 0.f);
    }
    cp_async_commit();
  };
  prefetch(0, 0);

  const int lo = k0 + warp * 16 + g, hi = lo + 8;
  uint32_t ka[4][4], va[4][4];
  load_a(ka, k + head_off, row_stride, lo, hi, S, t4);
  load_a(va, v + head_off, row_stride, lo, hi, S, t4);
  const float bias[2] = {key_bias(key_mask, lo, S), key_bias(key_mask, hi, S)};
  const bool exists[2] = {lo < S, hi < S};

  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
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
    const uint32_t qs = smem_u32(tiles[stage][0]), gs = smem_u32(tiles[stage][1]);

    float sc[8][4], dp[8][4];
    zero(sc);
    zero(dp);
    wgmma_fence();
    times_tile_rows(sc, ka, qs);  // S^T = k q^T
    times_tile_rows(dp, va, gs);  // dP^T = v dO^T
    wgmma_commit();
    fence(sc);
    fence(dp);
    wgmma_wait();
    fence(sc);
    fence(dp);

    // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float4 query = qinfo[stage][8 * j + 2 * t4 + (e & 1)];
        float p = ex2(fmaf(sc[j][e], kScale * kLog2e, query.x) + bias[r]);
        if (exists[r]) p += query.z;
        sc[j][e] = p;
        dp[j][e] = p * (dp[j][e] - query.y);
      }
    uint32_t pa[4][4], dsa[4][4];
    to_a(sc, pa);
    to_a(dp, dsa);
    wgmma_fence();
    times_tile(dv_acc, pa, gs);   // dV += P^T dO
    times_tile(dk_acc, dsa, qs);  // dK += dS^T q
    wgmma_commit();
    fence(dv_acc);
    fence(dk_acc);
    wgmma_wait();  // the tiles are read: the next prefetch may overwrite them
    fence(dv_acc);
    fence(dk_acc);
    __syncthreads();
  }
  const long long grad_off = (long long)b * S * grad_stride + (long long)h * kDh;
  store_rows(dk_acc, kScale, dk + grad_off, grad_stride, lo, hi, S, t4);
  store_rows(dv_acc, 1.f, dv + grad_off, grad_stride, lo, hi, S, t4);
}

}  // namespace

// Plain C entry point (loaded with ctypes); bf16 only, Dh = 64, no dropout.
// q, k, v: (B, S, H * 64) views with row stride row_stride (a multiple of 8
// elements, 16-byte aligned bases); mask: (B, S) bytes, nonzero = key kept, or
// NULL; out, dout: dense (B, S, H * 64); lse: (B, H, S) float32 from the
// forward; delta: (B, H, S) float32 scratch; dq, dk, dv: views with row stride
// grad_stride (even). Returns the cudaError_t of the three launches.
extern "C" int mmu_attention_bwd_tc(const void* q, const void* k, const void* v,
                                    long long row_stride, const void* mask, const void* out,
                                    const void* dout, const void* lse, void* delta, void* dq,
                                    void* dk, void* dv, long long grad_stride, int B, int S,
                                    int H, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || S < 1 || H < 1 || row_stride % 8 || grad_stride % 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* q_t = static_cast<const bf16*>(q);
  const bf16* k_t = static_cast<const bf16*>(k);
  const bf16* v_t = static_cast<const bf16*>(v);
  const bf16* dout_t = static_cast<const bf16*>(dout);
  const uint8_t* mask_t = static_cast<const uint8_t*>(mask);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);

  const long long rows = (long long)B * S;
  attention_bwd_tc_delta_kernel<<<(unsigned)((rows * H + 255) / 256), 256, 0, st>>>(
      static_cast<const bf16*>(out), dout_t, delta_f, rows, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((S + kRows - 1) / kRows, H, B);
  attention_bwd_tc_dq_kernel<<<grid, kThreads, 0, st>>>(q_t, k_t, v_t, row_stride, mask_t,
                                                        dout_t, lse_f, delta_f,
                                                        static_cast<bf16*>(dq), grad_stride, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  attention_bwd_tc_dkv_kernel<<<grid, kThreads, 0, st>>>(
      q_t, k_t, v_t, row_stride, mask_t, dout_t, lse_f, delta_f, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), grad_stride, S, H);
  return (int)cudaGetLastError();
}
