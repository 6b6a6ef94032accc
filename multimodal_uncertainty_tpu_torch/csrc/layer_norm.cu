// LayerNorm of each row with fp32 internals, for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the Pallas TPU kernel multimodal_uncertainty_tpu/ops/norms.py::
// layer_norm_pallas (:41, call :61, body _ln_kernel :31): 256-row blocks of a
// (rows, D) array in VMEM, normalised in fp32 and cast back to the input
// dtype. It is forward only there (no VJP), and so here.
//
// Per row:  mean = sum(x) / D,  xc = x - mean,  var = sum(xc * xc) / D,
//           y = xc * rsqrt(var + eps) * w + b
// in fp32, stored in x's dtype. The variance is taken from the centred values
// in a second pass over the row, as _ln_kernel does: E[x^2] - mean^2 would
// cancel away the variance of a row whose mean is large beside its spread
// (bf16 activations around 300, tests/test_ops.py). w and b are fp32. The
// products and sums of the last line are rounded one at a time (no fused
// multiply-add), as the plain PyTorch version computes them.
//
// Design: one warp owns a row, 8 rows a block. Its lanes stride the row in
// 16-byte vectors (4 fp32 or 8 bf16 a lane) when D, the row stride and the
// pointers allow it (the wrapper decides, VEC = true), else one element at a
// time. The three passes (sum, centred squares, output) read the row three
// times; only the first comes from device memory, the row (3 KB at D = 768 in
// fp32) is still in L1 for the other two. Warp shuffles do the sums: no
// shared memory, no atomics, and any number of rows (the last block's surplus
// warps return) and any D.
//
// What bounds it: memory. It does ~8 flops an element and moves each x once
// and each y once, 2 * rows * D * itemsize bytes: at FLAVA's LayerNorm
// (128 x 320 rows of 768) 252 MB in fp32, 75 us at the H100's 3.35 TB/s, and
// 38 us in bf16. Left for later: rows held in registers, several rows a warp
// at small D.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// N neighbouring elements of T at p, widened to fp32 (16 bytes when N is the
// vector width, one element when N is 1).
template <int N>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else if constexpr (N == 8) {
    load<4>(p, v);
    load<4>(p + 4, v + 4);
  } else {
    v[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  if constexpr (N == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = bf16_lo(w[i]);
      v[2 * i + 1] = bf16_hi(w[i]);
    }
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int N>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int N>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  if constexpr (N == 8) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    ln_rows_kernel(const T* __restrict__ x, long long ldx, const float* __restrict__ w,
                   const float* __restrict__ b, T* __restrict__ y, long long rows, int D,
                   float eps) {
  constexpr int N = VEC ? Vec<T>::N : 1;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * ldx;
  T* yr = y + row * (long long)D;
  float v[N];

  float acc = 0.f;
  for (int c = lane * N; c < D; c += 32 * N) {
    load<N>(xr + c, v);
#pragma unroll
    for (int i = 0; i < N; ++i) acc += v[i];
  }
  const float mean = warp_sum(acc) / (float)D;

  acc = 0.f;
  for (int c = lane * N; c < D; c += 32 * N) {
    load<N>(xr + c, v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float d = v[i] - mean;
      acc = __fadd_rn(acc, __fmul_rn(d, d));
    }
  }
  const float rstd = rsqrtf(warp_sum(acc) / (float)D + eps);

  float wv[N], bv[N];
  for (int c = lane * N; c < D; c += 32 * N) {
    load<N>(xr + c, v);
    load<N>(w + c, wv);
    load<N>(b + c, bv);
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = __fadd_rn(__fmul_rn(__fmul_rn(v[i] - mean, rstd), wv[i]), bv[i]);
    store<N>(yr + c, v);
  }
}

template <typename T>
cudaError_t launch(const void* x, long long ldx, const float* w, const float* b, void* y,
                   long long rows, int D, float eps, bool vec, cudaStream_t st) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (vec) {
    ln_rows_kernel<T, true><<<(unsigned)blocks, kThreads, 0, st>>>(xt, ldx, w, b, yt, rows, D,
                                                                    eps);
  } else {
    ln_rows_kernel<T, false><<<(unsigned)blocks, kThreads, 0, st>>>(xt, ldx, w, b, yt, rows, D,
                                                                     eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x (rows, D) of `dtype` (0 fp32, 1 bf16) with row stride ldx, w and b (D,)
// fp32 -> y (rows, D) of the same dtype, dense. vec != 0: D and ldx are
// multiples of the 16-byte vector (4 fp32, 8 bf16) and x, y, w, b are 16-byte
// aligned. Returns the launch's CUDA error code.
extern "C" int mmu_layer_norm(const void* x, long long ldx, const void* w, const void* b,
                              void* y, long long rows, int D, float eps, int dtype, int vec,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || D < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (dtype == 0) {
    err = launch<float>(x, ldx, wf, bf, y, rows, D, eps, vec != 0, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, ldx, wf, bf, y, rows, D, eps, vec != 0, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
