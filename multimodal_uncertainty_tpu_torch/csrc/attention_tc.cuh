// The pieces of the bf16 attention kernels on Hopper's tensor cores (sm_90a)
// that attention_fwd_tc.cu (Dh=64) and attention_bwd_tc.cuh share (the
// backward takes the primitives and widens the rest to its head dims): a block of
// two warpgroups owning 128 rows, 64-row tiles of 128-byte rows copied by
// cp.async into the 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)),
// the shared-memory descriptor through which wgmma reads such a tile (an atom
// of 8 rows of 128 bytes, the next 8 rows 1 KB on), and wgmma.m64n64k16 with A
// from registers and B from a tile, K-major (the tile's rows are the n
// dimension: a k16 step moves the descriptor 32 bytes) or MN-major (the rows
// are the k dimension: a k16 step moves it 2 KB). The fp32 accumulator layout
// is the register-A layout, so a product's result goes straight back as the A
// operand of the next (to_a).
#pragma once
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

}  // namespace
