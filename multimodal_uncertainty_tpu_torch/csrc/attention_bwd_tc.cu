// Masked multi-head attention backward for Hopper (sm_90a) in bf16 at Dh=64,
// without dropout, on the tensor cores.
//
// Replaces these Pallas TPU kernels of multimodal_uncertainty_tpu/ops/attention.py
// in bf16 at 64-wide heads (attention_bwd.cuh keeps every other dtype, head
// dim and the dropout instances):
//   * _sdpa_flash_bwd_stream_impl :1521 (bodies _attn_kernel_flash_dq_stream
//     :1374 and _attn_kernel_flash_dkv_stream :1421): the long-context
//     backward (K4, reached through attention_flash);
//   * _sdpa_packed_bwd_impl :813, _sdpa_flash_bwd_impl :1219 and
//     _sdpa_hl_bwd_impl :504 (K1, K3, K2 bwd) at 12 heads of 64.
//
// Function and contract: those of attention_bwd.cuh, unchanged. Three
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kDh = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;             // rows a block owns: two warpgroups of 64
constexpr int kTile = 64;                      // rows of a streamed tile
constexpr int kTileBytes = kTile * kDh * 2;    // 8 KB: 64 rows of 128 bytes
constexpr float kMaskBias = -1e30f;            // ops/attention.py NEG_INF
constexpr float kScale = 0.125f;               // 1 / sqrt(64), exact
constexpr float kLog2e = 1.4426950408889634f;

// Byte offset of 16-byte chunk c of row r in a tile: the 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

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

// Wait for this thread's copies (all but the newest N groups), and make them
// visible to the tensor cores' reads of shared memory (the async proxy).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Descriptor of a swizzled tile at addr: 8-row atoms of 128 bytes, 1 KB apart.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Keeps the compiler from touching registers that an issued wgmma still owns.
__device__ __forceinline__ void fence(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// d (64 x 64, fp32: d[j][e] is the m16n8 accumulator layout of each warp's 16
// rows, columns 8 j ..) += a (64 x 16 bf16, register fragments) b (16 x 64
// bf16 in shared memory; TRANS_B 0: K-major, 1: MN-major).
template <int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[8][4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// acc += a . tile^T: the tile's 64 rows are the n dimension, Dh the k one.
__device__ __forceinline__ void times_tile_rows(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                                uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma<0>(acc, a[kk], desc(tile + 32 * kk));
}

// acc += a . tile: the tile's 64 rows are the k dimension, Dh the n one.
__device__ __forceinline__ void times_tile(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                           uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma<1>(acc, a[kk], desc(tile + 2048 * kk));
}

__device__ __forceinline__ void zero(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
}

// Copy rows [row0, row0 + 64) of one head into a swizzled tile; rows at or
// past S are zero-filled (their source address is a valid row, not read).
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* base, long long stride,
                                          int row0, int S) {
  for (int i = threadIdx.x; i < kTile * 8; i += kThreads) {
    const int r = i / 8, c = i % 8;
    const int s = row0 + r;
    cp_async16(tile + swz(r, c), base + (long long)min(s, S - 1) * stride + c * 8, s < S);
  }
}

// This warp's 16 rows (lo = row g, hi = row g + 8 of its fragment) of one
// head as A fragments a[kk] for Dh columns 16 kk .. 16 kk + 15; zero past S.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* base, long long stride,
                                       int lo, int hi, int S, int t4) {
  const bf16* p_lo = base + (long long)lo * stride + 2 * t4;
  const bf16* p_hi = base + (long long)hi * stride + 2 * t4;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = lo < S ? *reinterpret_cast<const uint32_t*>(p_lo + 16 * kk) : 0u;
    a[kk][1] = hi < S ? *reinterpret_cast<const uint32_t*>(p_hi + 16 * kk) : 0u;
    a[kk][2] = lo < S ? *reinterpret_cast<const uint32_t*>(p_lo + 16 * kk + 8) : 0u;
    a[kk][3] = hi < S ? *reinterpret_cast<const uint32_t*>(p_hi + 16 * kk + 8) : 0u;
  }
}

// The accumulator x (64 x 64) rounded to bf16 A fragments over its 64
// columns: a[kk] takes columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ void to_a(const float (&x)[8][4], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j / 2][(j & 1) * 2] = pack(x[j][0], x[j][1]);
    a[j / 2][(j & 1) * 2 + 1] = pack(x[j][2], x[j][3]);
  }
}

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
