// The pieces that the attention kernels on register micro-tiles and
// thread-block clusters share: attention_fwd_wide.cuh (the forward at Dh 256,
// 384 and 768) and attention_bwd_wide.cuh (the backward at Dh 24 to 768).
// Their blocks keep fp32 tiles in shared memory with rows of C floats, the
// 16-byte chunk c of row r at chunk c ^ (r % 8), or rows padded by one chunk
// where C is no multiple of 32 (at), so that the 8 threads of a quarter warp
// that load neighbouring rows, or neighbouring chunks of one row, hit
// distinct banks; they fill them with cp.async; and the blocks of a cluster
// read and write each other's shared memory (cluster.cuh) between
// barrier.cluster rendezvous. Both kernels are fp32 only: every bf16 launch
// runs on the tensor cores (attention_{fwd,bwd}_tc*.cuh).
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;         // rows of a streamed tile
constexpr float kMaskBias = -1e30f;  // ops/attention.py NEG_INF

// Floats a row of a tile of C-float rows takes in shared memory: C where a
// row is whole groups of 8 chunks (swizzled, below), else C + 4. C is a
// multiple of 8, so C / 4 + 1 chunks is odd, and 8 rows that are distinct
// mod 8 start in 8 distinct chunk slots of the banks.
template <int C>
__host__ __device__ constexpr int pitch() {
  return (C / 4) % 8 == 0 ? C : C + 4;
}

// Float offset of 16-byte chunk c of row r in a tile of C-float rows: at C %
// 32 == 0 the chunk sits at c ^ (r % 8), else rows are padded (pitch).
template <int C>
__device__ __forceinline__ int at(int r, int c) {
  if constexpr ((C / 4) % 8 == 0)
    return r * C + ((c ^ (r & 7)) << 2);
  else
    return r * (C + 4) + (c << 2);
}

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

// The barrier between the cluster's blocks (N = 1: the block's).
template <int N>
__device__ __forceinline__ void rendezvous() {
  if constexpr (N == 1)
    __syncthreads();
  else
    cluster_sync();
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

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float comp(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
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

// Four neighbouring values (dst 16-byte aligned).
__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

// Rows [row0, row0 + ROWS) of one operand's C-column slice (from base, row
// stride `stride`) into the fp32 tile (at) by cp.async (committed by the
// caller); rows at or past S are zero-filled.
template <int ROWS, int C>
__device__ __forceinline__ void load_rows(float* tile, const float* base, long long stride,
                                          int row0, int S) {
  for (int i = threadIdx.x; i < ROWS * (C / 4); i += kThreads) {
    const int r = i / (C / 4), c = i % (C / 4);
    const int s = row0 + r;
    cp_async16(smem_u32(tile + at<C>(r, c)), base + (long long)min(s, S - 1) * stride + 4 * c,
               s < S);
  }
}

// A library's list of head dims (MMU_*_DIMS), for the dispatch on dh.
template <int... DHS>
struct Dims {};

}  // namespace
