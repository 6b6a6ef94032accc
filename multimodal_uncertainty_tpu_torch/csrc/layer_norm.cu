// LayerNorm of each row with fp32 internals, for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the Pallas TPU kernel multimodal_uncertainty_tpu/ops/norms.py::
// layer_norm_pallas (:41, call :61, body _ln_kernel :31): 256-row blocks of a
// (rows, D) array in VMEM, normalised in fp32 and cast back to the input
// dtype. It is forward only there (no VJP), and so here.
//
// Per row:  mean = sum(x) / D,  xc = x - mean,  var = sum(xc * xc) / D,
//           y = xc * rsqrt(var + eps) * w + b
// in fp32, stored in x's dtype. The variance is taken from the centred values,
// as _ln_kernel does: E[x^2] - mean^2 would cancel away the variance of a row
// whose mean is large beside its spread (bf16 activations around 300,
// tests/test_ops.py). w and b are fp32. The products and sums of the last line
// are rounded one at a time (no fused multiply-add), as the plain PyTorch
// version computes them.
//
// What bounds it: memory. It does ~8 flops an element and moves each x once
// and each y once, 2 * rows * D * itemsize bytes: at the FLAVA predictor's
// LayerNorm (32 x 320 rows of 768) 63 MB in fp32, 18.8 us at the H100's
// 3.35 TB/s (9.4 us in bf16); at training's 128 x 320 rows 75 us.
//
// Design: one warp owns a row at a time and walks rows [warp, warp + warps,
// ...) of a grid sized to the blocks the SMs hold at once. Instances NV > 0
// hold the row in registers: a lane holds NV 16-byte vectors (4 fp32 or 8
// bf16 each), vector j of lane l at columns (32 j + l) * 4 or * 8, so D =
// 32 * NV * 4 (fp32) or 32 * NV * 8 (bf16); at D = 768, 6 float4 or 3 uint4 a
// lane. Every load of a row is issued before its first reduction, and the next
// row's loads before this row's reductions, so a warp keeps two rows in
// flight; the row is read from device memory once and never again (the mean
// and the centred squares come from the registers), x is read and y written
// with the streaming hints (ld/st .cs); w and b sit in registers for the
// warp's life. Up to 24 elements a lane (D = 768) the instance is held to 128
// registers, so that two blocks of 8 warps share an SM. Warp shuffles do the sums: no shared memory, no atomics. The
// generic instance, NV = 0, takes any D, row stride and alignment (a D that no
// register instance covers, up to 32 elements a lane, or unaligned rows): the
// same arithmetic one element at a time in three passes over the row, the
// second and third from L1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxElems = 32;  // elements a lane holds in a register instance: D <= 1024
constexpr int kMaxVecs = 8;
// Instances of at most this many elements a lane fit 128 registers, two blocks an SM (D = 768
// holds 24: at one block an SM it took 130 registers and read 10 % slower at 10240 rows).
constexpr int kTwoBlockElems = 24;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void unpack(float4 a, float* v) {
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

// 4 floats of w or b at p (kept in the caches: every warp reads them).
__device__ __forceinline__ void load4(const float* p, float* v) {
  unpack(*reinterpret_cast<const float4*>(p), v);
}

// 16 bytes of x at p, widened to fp32, read once (streaming).
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  unpack(__ldcs(reinterpret_cast<const float4*>(p)), v);
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = bf16_lo(w[i]);
    v[2 * i + 1] = bf16_hi(w[i]);
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float normed(float v, float mean, float rstd, float w, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(v - mean, rstd), w), b);
}

// Row `row` of x into this lane's registers: vector j at columns (32 j + lane) * N.
template <typename T, int NV>
__device__ __forceinline__ void load_row(const T* __restrict__ x, long long ldx, long long row,
                                         int lane, float (&v)[NV * Vec<T>::N]) {
  constexpr int N = Vec<T>::N;
  const T* xr = x + row * ldx;
#pragma unroll
  for (int j = 0; j < NV; ++j) load_vec(xr + (32 * j + lane) * N, v + j * N);
}

// grid: at most the blocks the SMs hold at once; block kThreads. Warp w of
// the grid normalises rows w, w + warps, ... NV > 0: D == 32 * NV * N, ldx a
// multiple of N, x, y, w, b 16-byte aligned; NV == 0: any D and ldx.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, NV * Vec<T>::N <= kTwoBlockElems ? 2 : 1)
    ln_rows_kernel(const T* __restrict__ x, long long ldx, const float* __restrict__ w,
                   const float* __restrict__ b, T* __restrict__ y, long long rows, int D,
                   float eps) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  if constexpr (NV > 0) {
    constexpr int N = Vec<T>::N;
    constexpr int E = NV * N;
    float wv[E], bv[E], v[E];
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        load4(w + (32 * j + lane) * N + i, wv + j * N + i);
        load4(b + (32 * j + lane) * N + i, bv + j * N + i);
      }
    load_row<T, NV>(x, ldx, row, lane, v);
    for (; row < rows; row += stride) {
      float next[E];
      if (row + stride < rows) load_row<T, NV>(x, ldx, row + stride, lane, next);
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc += v[e];
      const float mean = warp_sum(acc) / (float)D;
      acc = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = v[e] - mean;
        acc = __fadd_rn(acc, __fmul_rn(d, d));
      }
      const float rstd = rsqrtf(warp_sum(acc) / (float)D + eps);
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = normed(v[e], mean, rstd, wv[e], bv[e]);
      T* yr = y + row * (long long)D;
#pragma unroll
      for (int j = 0; j < NV; ++j) store_vec(yr + (32 * j + lane) * N, v + j * N);
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = next[e];
    }
  } else {
    for (; row < rows; row += stride) {
      const T* xr = x + row * ldx;
      T* yr = y + row * (long long)D;
      float acc = 0.f;
      for (int c = lane; c < D; c += 32) acc += to_float(xr[c]);
      const float mean = warp_sum(acc) / (float)D;
      acc = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float d = to_float(xr[c]) - mean;
        acc = __fadd_rn(acc, __fmul_rn(d, d));
      }
      const float rstd = rsqrtf(warp_sum(acc) / (float)D + eps);
      for (int c = lane; c < D; c += 32)
        from_float(yr + c, normed(to_float(xr[c]), mean, rstd, w[c], b[c]));
    }
  }
}

template <typename T, int NV>
cudaError_t launch_nv(const T* x, long long ldx, const float* w, const float* b, T* y,
                      long long rows, int D, float eps, cudaStream_t st) {
  if constexpr (NV * Vec<T>::N > kMaxElems) {
    return cudaErrorInvalidValue;
  } else {
    if (NV > 0 && (D != 32 * NV * Vec<T>::N || ldx % Vec<T>::N)) return cudaErrorInvalidValue;
    static int per_sm = 0;  // blocks of this instance an SM holds at once
    int device, sms;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess && per_sm == 0)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ln_rows_kernel<T, NV>, kThreads,
                                                          0);
    if (err != cudaSuccess) return err;
    const long long wanted = (rows + kWarps - 1) / kWarps;
    const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    const unsigned blocks = static_cast<unsigned>(wanted < resident ? wanted : resident);
    ln_rows_kernel<T, NV><<<blocks, kThreads, 0, st>>>(x, ldx, w, b, y, rows, D, eps);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch(const void* xv, long long ldx, const float* w, const float* b, void* yv,
                   long long rows, int D, float eps, int nv, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  switch (nv) {
    case 0: return launch_nv<T, 0>(x, ldx, w, b, y, rows, D, eps, st);
    case 1: return launch_nv<T, 1>(x, ldx, w, b, y, rows, D, eps, st);
    case 2: return launch_nv<T, 2>(x, ldx, w, b, y, rows, D, eps, st);
    case 3: return launch_nv<T, 3>(x, ldx, w, b, y, rows, D, eps, st);
    case 4: return launch_nv<T, 4>(x, ldx, w, b, y, rows, D, eps, st);
    case 5: return launch_nv<T, 5>(x, ldx, w, b, y, rows, D, eps, st);
    case 6: return launch_nv<T, 6>(x, ldx, w, b, y, rows, D, eps, st);
    case 7: return launch_nv<T, 7>(x, ldx, w, b, y, rows, D, eps, st);
    case 8: return launch_nv<T, 8>(x, ldx, w, b, y, rows, D, eps, st);
    default: return cudaErrorInvalidValue;
  }
}

static_assert(kMaxVecs * Vec<float>::N == kMaxElems, "the fp32 instances span D up to 1024");

}  // namespace

// x (rows, D) of `dtype` (0 fp32, 1 bf16) with row stride ldx, w and b (D,)
// fp32 -> y (rows, D) of the same dtype, dense. nv: the instance, 0 (generic:
// any D, ldx and alignment) or the 16-byte vectors a lane holds, 1 .. 8 in
// fp32 and 1 .. 4 in bf16, with D = 32 * nv * (4 fp32, 8 bf16), ldx a multiple
// of the vector and x, y, w, b 16-byte aligned. Returns the launch's CUDA
// error code.
extern "C" int mmu_layer_norm(const void* x, long long ldx, const void* w, const void* b,
                              void* y, long long rows, int D, float eps, int dtype, int nv,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || D < 1 || nv < 0 || nv > kMaxVecs) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (dtype == 0) {
    err = launch<float>(x, ldx, wf, bf, y, rows, D, eps, nv, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, ldx, wf, bf, y, rows, D, eps, nv, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
