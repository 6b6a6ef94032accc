// The pieces of the bf16 attention kernels on Hopper's tensor cores (sm_90a)
// that the forwards (attention_fwd_tc.cuh, attention_fwd_tc_wide.cuh) and the
// backwards (attention_bwd_tc.cuh, attention_bwd_tc_wide.cuh) share, at every
// head dim they are built for: blocks of two warpgroups (kThreads), tiles of
// 128-byte rows copied by cp.async into the 128-byte swizzle (16-byte chunk c
// of row r at c ^ (r % 8)) and stored in 64-column panels, the shared-memory
// descriptors through which wgmma reads such a tile (an atom of 8 rows of 128
// bytes, the next 8 rows 1 KB on; K-major: the tile's rows are the m or n
// dimension, a k16 step moves the descriptor 32 bytes; MN-major: the rows are
// the k dimension, a k16 step moves it 2 KB and the leading-byte offset steps
// n from panel to panel), and wgmma.m64nNk16 at the widths the kernels take,
// with A from registers or from a tile. The fp32 accumulator layout is the
// register-A layout, so a product's result goes straight back as the A
// operand of the next (to_a_n). scale_of holds each built head dim's 1 /
// sqrt(Dh). Head dims below a panel (24, 48) pad their rows to 128 bytes; the
// K-major products' k16 steps stop at Dh rounded up to 16 columns (the
// padding they read is zero), the MN-major ones take n = Dh and never read
// it. Then the backwards' shared pieces (the P rule's row and key terms, the
// exchange tile's stores, the delta pass) and dropout's keep mask packed into
// bits and read back.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;          // two warpgroups
constexpr float kMaskBias = -1e30f;            // ops/attention.py NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMaskBias2 = kMaskBias * kLog2e;  // the masked bias in the exp2 domain

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

// The max and the sum of x over the four threads of an accumulator row
// (lanes 4 g .. 4 g + 3).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// 1 / sqrt(Dh) as the plain version rounds it, at the head dims built here,
// the whole head's (a kernel that splits Dh into slices keys it on Dh, never
// on the slice; tests/test_torch_attention.py reads these constants).
template <int DH>
__host__ __device__ constexpr float scale_of() {
  static_assert(DH == 24 || DH == 32 || DH == 48 || DH == 64 || DH == 96 || DH == 128 ||
                    DH == 192 || DH == 256 || DH == 384 || DH == 768,
                "a new head dim needs its 1 / sqrt(Dh) here");
  return DH == 24    ? 0.20412414523193154f
         : DH == 32  ? 0.17677669529663687f
         : DH == 48  ? 0.14433756729740646f
         : DH == 64  ? 0.125f
         : DH == 96  ? 0.10206207261596575f
         : DH == 128 ? 0.08838834764831843f
         : DH == 192 ? 0.07216878364870323f
         : DH == 256 ? 0.0625f
         : DH == 384 ? 0.051031036307982884f
         : DH == 768 ? 0.036084391824351615f
                     : 0.f;
}

// Descriptor of a 128-byte-swizzled operand at addr (8-row atoms 1 KB
// apart); lbo: bytes from one 64-column panel to the next, which an MN-major
// read crosses (a K-major one never does: 16).
__device__ __forceinline__ uint64_t desc_lbo(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The other widths of wgmma.m64nNk16: d (64 x N fp32) += a (64 x 16 bf16,
// register fragments) b (16 x N in shared memory; TRANS_B 0: K-major, 1:
// MN-major), and wgmma_ss with A from shared memory too (K-major).
template <int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[3][4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, %18;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[6][4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[4][4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[12][4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[16][4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[24][4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[32][4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[4][4], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[24][4], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, %99;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

template <int J>
__device__ __forceinline__ void fence_n(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

template <int J>
__device__ __forceinline__ void zero_n(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
}

// The accumulator x (64 x 8 J) rounded to bf16 A fragments: a[kk] takes
// columns 16 kk .. 16 kk + 15.
template <int J>
__device__ __forceinline__ void to_a_n(const float (&x)[J][4], uint32_t (&a)[J / 2][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    a[j / 2][(j & 1) * 2] = pack(x[j][0], x[j][1]);
    a[j / 2][(j & 1) * 2 + 1] = pack(x[j][2], x[j][3]);
  }
}

// Copy rows [row0, row0 + ROWS) of one head (DH columns; or a DH-column
// slice of it, from base) into a tile of 64-column panels, ROWS x 128 bytes
// each, in the 128-byte swizzle; rows at or past S are zero-filled (their
// source address is a valid row, not read). A head dim of an odd number of
// 16-byte chunks (24) also zero-fills the chunk after its last, which the
// K-major products' last k16 step reads: an earlier tile's bytes there could
// be NaN, and 0 x NaN is NaN.
template <int DH, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t tile, const bf16* base, long long stride,
                                          int row0, int S) {
  constexpr int kData = DH / 8;                // 16-byte chunks a row holds
  constexpr int kChunks = (DH + 15) / 16 * 2;  // and those the k16 steps read
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int s = row0 + r;
    cp_async16(tile + (c / 8) * (ROWS * 128) + swz(r, c % 8),
               base + (long long)min(s, S - 1) * stride + (c < kData ? c * 8 : 0),
               s < S && c < kData);
  }
}

// This warp's 16 rows (lo = row g, hi = row g + 8 of its fragment) of one
// head as A fragments a[kk] for Dh columns 16 kk .. 16 kk + 15; zero past S
// and past Dh (at Dh 24 the second step's upper half: those columns belong to
// the next head, or lie past the tensor's end on its last row).
template <int DH, int KSTEPS>
__device__ __forceinline__ void load_a_n(uint32_t (&a)[KSTEPS][4], const bf16* base,
                                         long long stride, int lo, int hi, int S, int t4) {
  static_assert(KSTEPS == (DH + 15) / 16, "k16 steps over Dh");
  const bf16* p_lo = base + (long long)lo * stride + 2 * t4;
  const bf16* p_hi = base + (long long)hi * stride + 2 * t4;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    a[kk][0] = lo < S ? *reinterpret_cast<const uint32_t*>(p_lo + 16 * kk) : 0u;
    a[kk][1] = hi < S ? *reinterpret_cast<const uint32_t*>(p_hi + 16 * kk) : 0u;
    if (16 * kk + 8 < DH) {
      a[kk][2] = lo < S ? *reinterpret_cast<const uint32_t*>(p_lo + 16 * kk + 8) : 0u;
      a[kk][3] = hi < S ? *reinterpret_cast<const uint32_t*>(p_hi + 16 * kk + 8) : 0u;
    } else {
      a[kk][2] = a[kk][3] = 0u;
    }
  }
}

// Store a warp's 16 x 8 J accumulator times `mul` as bf16 columns c0 .. of
// rows lo / hi (skipped past S).
template <int J>
__device__ __forceinline__ void store_rows_n(const float (&acc)[J][4], float mul, bf16* base,
                                             long long stride, int c0, int lo, int hi, int S,
                                             int t4) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int col = c0 + 8 * j + 2 * t4;
    if (lo < S)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)lo * stride + col) =
          __floats2bfloat162_rn(acc[j][0] * mul, acc[j][1] * mul);
    if (hi < S)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)hi * stride + col) =
          __floats2bfloat162_rn(acc[j][2] * mul, acc[j][3] * mul);
  }
}

// Descriptors of the k16 step kk of an operand tile of ROWS rows in 64-column
// panels: K-major (the tile's rows are m or n, Dh is k) and MN-major (the
// tile's rows are k, Dh columns c0 .. are n). A single-panel tile keeps the
// unused leading-byte offset at 16.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc_lbo(tile + (kk / 4) * (ROWS * 128) + 32 * (kk % 4), 16);
}
template <int ROWS, int PANELS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int c0, int kk) {
  return desc_lbo(tile + (c0 / 64) * (ROWS * 128) + 2048 * kk, PANELS > 1 ? ROWS * 128 : 16);
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The backward's pieces (attention_bwd_tc.cuh, attention_bwd_tc_wide.cuh) and
// the dropout forward's (attention_fwd_tc.cuh).

// A key's exponent bias: 0 if kept, -inf if masked or past S (P = 0).
__device__ __forceinline__ float key_bias(const uint8_t* key_mask, int key, int S) {
  return key >= S || (key_mask && !key_mask[key]) ? -INFINITY : 0.f;
}

// A query row's -lse in the exp2 domain, -inf when the row is fully masked
// (lse <= -5e29: its P is the uniform 1/S, added apart) or past S.
__device__ __forceinline__ float neg_lse2(float lse, bool exists) {
  return exists && lse > 0.5f * kMaskBias ? -lse * kLog2e : -INFINITY;
}

// The (B, H, S, S) keep bytes of dropout as bits, by rows (rows[plane][q][w],
// bit i: key 32 w + i of query q) and, with COLS, by columns
// (cols[plane][k][w], bit i: query 32 w + i of key k), W = ceil(S / 32) words
// a row, 0 past S. A warp packs the 32 x 32 block (key block blockIdx.x,
// query block 8 blockIdx.y + warp) of plane blockIdx.z: lane = key, one
// coalesced 32-byte load and a ballot a query. The body of the dropout
// kernels' packing launches (256 threads, grid (W, ceil(W / 8), B H)).
template <bool COLS>
__device__ __forceinline__ void pack_keep(const uint8_t* __restrict__ keep,
                                          uint32_t* __restrict__ rows,
                                          uint32_t* __restrict__ cols, int S, int W) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kb = blockIdx.x, qb = blockIdx.y * 8 + warp;
  if (qb >= W) return;  // the whole warp
  const long long plane = blockIdx.z;
  const uint8_t* base = keep + plane * S * S;
  const int k = 32 * kb + lane;
  uint32_t row_word = 0, col_word = 0;
#pragma unroll 8
  for (int m = 0; m < 32; ++m) {
    const int q = 32 * qb + m;
    const bool on = q < S && k < S && base[(long long)q * S + k] != 0;
    const uint32_t word = __ballot_sync(0xffffffffu, on);
    if (lane == m) row_word = word;
    if constexpr (COLS) col_word |= (uint32_t)on << m;
  }
  const long long off = plane * S * W;
  if (32 * qb + lane < S) rows[off + (long long)(32 * qb + lane) * W + kb] = row_word;
  if constexpr (COLS) {
    if (k < S) cols[off + (long long)k * W + qb] = col_word;
  }
}

// This thread's keep bits of a tile (dropout): bit 4 j + e is element e of
// 8-column block j of its accumulator, rows lo / hi (e >> 1) of the warp and
// columns c0 + 8 j + 2 t4 + (e & 1) (c0 a multiple of 32), from the packed
// words of the pass's (batch, head) plane: the rows' for the dQ pass (rows
// are queries), the columns' for the dK/dV pass (rows are keys).
template <int NJ>
__device__ __forceinline__ uint32_t keep_bits(const uint32_t* words, int lo, int hi, int c0,
                                              int S, int W, int t4) {
  static_assert(NJ * 4 <= 32, "a tile's keep bits fit one word");
  constexpr int kWords = (8 * NJ + 31) / 32;  // words a row of the tile
  uint32_t w[2][kWords];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? hi : lo;
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      w[r][i] = row < S && c0 / 32 + i < W ? words[(long long)row * W + c0 / 32 + i] : 0u;
  }
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      bits |= ((w[e >> 1][j / 4] >> (8 * (j % 4) + 2 * t4 + (e & 1))) & 1u) << (4 * j + e);
  return bits;
}

// Write a warp's 16 x 8 J scores, rounded to bf16, into columns col0 .. of a
// 64-row exchange tile of 128-byte rows in the 128-byte swizzle, and (fence)
// make the block's writes visible to the tensor cores' reads.
template <int J>
__device__ __forceinline__ void store_xchg(const float (&x)[J][4], uint8_t* tile, int col0,
                                           int warp, int g, int t4) {
  const int lo = warp * 16 + g, hi = lo + 8;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = col0 / 8 + j;
    *reinterpret_cast<uint32_t*>(tile + lo * 128 + ((c ^ (lo & 7)) << 4) + 4 * t4) =
        pack(x[j][0], x[j][1]);
    *reinterpret_cast<uint32_t*>(tile + hi * 128 + ((c ^ (hi & 7)) << 4) + 4 * t4) =
        pack(x[j][2], x[j][3]);
  }
}

// The backward's first pass: delta = rowsum(dO * O) per (row, head). A block
// takes delta_pairs<DH>() consecutive (row, head) pairs of the dense (B, S, H,
// Dh) out and dout, DH / 8 threads a pair, each one 16-byte chunk of both
// (consecutive threads read consecutive chunks); the chunks' partial sums
// meet in shared memory. 16 pairs a block, 8 at Dh 768 (1024 threads at most).
template <int DH>
__host__ __device__ constexpr int delta_pairs() {
  return DH > 512 ? 8 : 16;
}
template <int DH>
__global__ void __launch_bounds__(delta_pairs<DH>() * DH / 8)
attention_bwd_tc_delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                              float* __restrict__ delta, long long pairs, int S, int H) {
  constexpr int kChunks = DH / 8, kDeltaPairs = delta_pairs<DH>();
  __shared__ float part[kDeltaPairs * (kChunks + 1)];  // a pair's row padded by one word
  const long long first = (long long)blockIdx.x * kDeltaPairs;  // (b * S + s) * H + h
  const long long chunk = first * kChunks + threadIdx.x;
  float acc = 0.f;
  if (chunk < pairs * kChunks) {
    const uint4 a = reinterpret_cast<const uint4*>(out)[chunk];
    const uint4 b = reinterpret_cast<const uint4*>(dout)[chunk];
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[w]));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw[w]));
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  part[threadIdx.x / kChunks * (kChunks + 1) + threadIdx.x % kChunks] = acc;
  __syncthreads();
  const long long i = first + threadIdx.x;
  if (threadIdx.x < kDeltaPairs && i < pairs) {
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) sum += part[threadIdx.x * (kChunks + 1) + c];
    const long long row = i / H;
    const long long b = row / S;
    delta[(b * H + i % H) * S + row % S] = sum;
  }
}

template <int DH>
cudaError_t launch_delta(const bf16* out, const bf16* dout, float* delta, int B, int S, int H,
                         cudaStream_t st) {
  constexpr int kPairs = delta_pairs<DH>();
  const long long pairs = (long long)B * S * H;
  attention_bwd_tc_delta_kernel<DH>
      <<<(unsigned)((pairs + kPairs - 1) / kPairs), kPairs * DH / 8, 0, st>>>(out, dout, delta,
                                                                             pairs, S, H);
  return cudaGetLastError();
}

}  // namespace
