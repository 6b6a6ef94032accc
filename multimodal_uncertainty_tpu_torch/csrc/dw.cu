// Weight gradient of a Linear for Hopper (sm_90a): dW = dY^T X, fp32 result.
//
// Replaces the Pallas TPU kernel multimodal_uncertainty_tpu/ops/dw.py::
// _dw_pallas_2d (body _dw_kernel): dW = X^T dY over the K = B*S rows of a
// Linear's input X (K, Din) and output gradient dY (K, Dout), accumulated in
// fp32, for fp32 or bf16 inputs. The TPU kernel carried a (Din, bn) fp32
// accumulator in VMEM across a sequential K grid axis and padded K with zero
// rows to its block. Here blocks run in parallel and in no order: each block
// owns one 128 x 128 output tile and loops over its K range itself; any K is
// taken, the ragged last chunk masked in the loads (no padding copies).
//
// Layout: the result is written in torch's (Dout, Din) layout, the weight's
// own, so the autograd Function returns it with no transpose:
//     out[o][i] = sum_k dY[k][o] * X[k][i].
// Both operands are read in their natural K-major layout: a K-slice of dY
// (8 rows x 128 columns of o) and of X (8 rows x 128 columns of i) are
// contiguous 512-byte row pieces, stored to shared memory as they are, and
// the product is a sum of outer products (the "NT" case of a GEMM), so no
// transpose happens anywhere. X and dY may have any row stride that keeps
// 16-byte (fp32) or 8-byte (bf16) loads aligned, so a strided view such as
// x[:, 0] (the pooler's input) is read in place.
//
// What bounds it: 2 K Din Dout fp32 FMA operations; at ViLT's fc1 (K = 5920,
// Din 768, Dout 3072) that is 27.9 GFLOP, 0.417 ms at the H100's 67 TFLOP/s
// outside the tensor cores, against 0.030 ms for its bytes: the kernel is
// compute-bound. The design is the classic SIMT register-blocked product:
// 256 threads, each accumulating an 8 x 8 piece of the tile in registers
// (64 FMAs per 16 shared-memory floats read), K-slices of 8 double-buffered
// through registers so the next slice's global loads overlap this slice's
// FMAs. bf16 inputs are widened to fp32 on load and take the same fp32 FMA
// path: exact products, but at the fp32 rate, far below bf16's tensor-core
// bound (wgmma and TMA are later work).
//
// Occupancy: a Din x Dout output of 768 x 768 has only 36 tiles for 132 SMs.
// The wrapper therefore splits K over `splits` blocks per tile (blockIdx.z);
// each writes its partial tile to its own fp32 slab of a workspace, and a
// second kernel sums the slabs in a fixed order, so the result does not
// depend on scheduling (no atomics). With splits == 1 the tile goes straight
// to the output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;  // output rows per tile (o, Dout)
constexpr int BN = 128;  // output columns per tile (i, Din)
constexpr int BK = 8;    // K rows per slice
constexpr int THREADS = 256;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// grid (Din / BN, Dout / BM, splits); block THREADS. Block z sums rows
// [z * k_chunk, min(K, (z + 1) * k_chunk)) into out + z * Dout * Din.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
dw_kernel(const T* __restrict__ x, long long ldx, const T* __restrict__ dy, long long ldy,
          float* __restrict__ out, int K, int Din, int Dout, int k_chunk) {
  __shared__ __align__(16) float As[2][BK][BM];  // dY slice: [k][o]
  __shared__ __align__(16) float Bs[2][BK][BN];  // X slice:  [k][i]

  const int tid = threadIdx.x;
  const int o0 = blockIdx.y * BM;
  const int i0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  out += static_cast<long long>(blockIdx.z) * Dout * Din;

  // loads: warp w reads row w of the slice, 4 neighbouring columns a lane
  const int lr = tid >> 5;
  const int lc = (tid & 31) * 4;
  // compute: rows ty*4 .. +3 and 64 + ty*4 .. +3, columns tx*4 .. +3 and 64 + tx*4 .. +3
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 a4 = zero, b4 = zero;
  if (kbeg + lr < kend) {
    a4 = load4(dy + static_cast<long long>(kbeg + lr) * ldy + o0 + lc);
    b4 = load4(x + static_cast<long long>(kbeg + lr) * ldx + i0 + lc);
  }
  *reinterpret_cast<float4*>(&As[0][lr][lc]) = a4;
  *reinterpret_cast<float4*>(&Bs[0][lr][lc]) = b4;
  __syncthreads();

  int buf = 0;
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    const bool more = k0 + BK < kend;
    if (more) {  // the next slice into registers while this one is multiplied
      const int k = k0 + BK + lr;
      a4 = zero;
      b4 = zero;
      if (k < kend) {
        a4 = load4(dy + static_cast<long long>(k) * ldy + o0 + lc);
        b4 = load4(x + static_cast<long long>(k) * ldx + i0 + lc);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    if (more) {
      // every thread passed the previous barrier after its reads of buf ^ 1
      *reinterpret_cast<float4*>(&As[buf ^ 1][lr][lc]) = a4;
      *reinterpret_cast<float4*>(&Bs[buf ^ 1][lr][lc]) = b4;
      __syncthreads();
      buf ^= 1;
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int o = o0 + (r < 4 ? ty * 4 + r : 64 + ty * 4 + (r - 4));
    float* row = out + static_cast<long long>(o) * Din + i0;
    *reinterpret_cast<float4*>(row + tx * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    *reinterpret_cast<float4*>(row + 64 + tx * 4) =
        make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
}

// out[j] = sum over z of ws[z][j], z in order; n4 float4s per slab.
__global__ void dw_reduce(const float4* __restrict__ ws, float4* __restrict__ out, long long n4,
                          int splits) {
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; j < n4;
       j += static_cast<long long>(gridDim.x) * blockDim.x) {
    float4 s = ws[j];
    for (int z = 1; z < splits; ++z) {
      const float4 t = ws[z * n4 + j];
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    out[j] = s;
  }
}

template <typename T>
cudaError_t launch(const void* x, long long ldx, const void* dy, long long ldy, float* out,
                   float* workspace, int K, int Din, int Dout, int splits, int k_chunk,
                   cudaStream_t st) {
  const dim3 grid(Din / BN, Dout / BM, splits);
  float* target = splits > 1 ? workspace : out;
  dw_kernel<T><<<grid, THREADS, 0, st>>>(static_cast<const T*>(x), ldx,
                                         static_cast<const T*>(dy), ldy, target, K, Din, Dout,
                                         k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n4 = static_cast<long long>(Din) * Dout / 4;
  const int blocks = static_cast<int>((n4 + THREADS - 1) / THREADS < 4096
                                          ? (n4 + THREADS - 1) / THREADS
                                          : 4096);
  dw_reduce<<<blocks, THREADS, 0, st>>>(reinterpret_cast<const float4*>(workspace),
                                        reinterpret_cast<float4*>(out), n4, splits);
  return cudaGetLastError();
}

}  // namespace

// x (K, Din) with row stride ldx, dy (K, Dout) with row stride ldy, both of
// `dtype` (0 fp32, 1 bf16) -> out (Dout, Din) fp32, dense. Din and Dout are
// multiples of 128; `workspace` holds splits * Dout * Din floats when
// splits > 1 (else it may be null); block z of a tile sums rows
// [z * k_chunk, (z + 1) * k_chunk). Returns the launch's CUDA error code.
extern "C" int mmu_dw(const void* x, long long ldx, const void* dy, long long ldy, void* out,
                      void* workspace, int K, int Din, int Dout, int splits, int k_chunk,
                      int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Din % BN || Dout % BM || splits < 1 || k_chunk % BK || K < 0 ||
      (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* ws = static_cast<float*>(workspace);
  if (dtype == 0) {
    err = launch<float>(x, ldx, dy, ldy, o, ws, K, Din, Dout, splits, k_chunk, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, ldx, dy, ldy, o, ws, K, Din, Dout, splits, k_chunk, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
