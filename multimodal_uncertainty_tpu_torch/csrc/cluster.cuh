// Thread-block clusters (sm_90): the block's rank and its cluster's index,
// the cluster-wide barrier, loads and stores of another block's shared
// memory (distributed shared memory: mapa turns a shared address of this
// block into the same address of the cluster's block `rank`), and the launch
// on clusters. One copy for every kernel on clusters: the FMA kernels of
// attention_cluster.cuh and the tensor-core ones of attention_fwd_tc_wide.cuh
// and attention_bwd_tc_wide.cuh. It holds nothing else, so that it sits
// beside either attention_cluster.cuh or attention_tc.cuh, which define their
// own block shapes and copies (kThreads, load_rows, cp_async_wait) and so
// cannot be included together.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

// The float4 / float at shared address addr of the cluster's block `rank`.
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr, uint32_t rank) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(map_rank(addr, rank))
               : "memory");
  return v;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr, uint32_t rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(map_rank(addr, rank)) : "memory");
  return v;
}

// Store x at shared address addr of the cluster's block `rank`.
__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t rank, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(map_rank(addr, rank)), "f"(x) : "memory");
}

__device__ __forceinline__ void st_cluster_u32(uint32_t addr, uint32_t rank, uint32_t x) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(map_rank(addr, rank)), "r"(x) : "memory");
}

// Launch `kernel` on clusters of N blocks along x (N = 1: no cluster) of
// `threads` threads, with `smem` bytes of dynamic shared memory.
template <int N, typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, const dim3& grid, int threads, int smem,
                            cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = N > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace
