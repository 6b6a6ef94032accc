// Masked attention forward for Hopper (sm_90a) at the wide head dims, Dh 256,
// 384 and 768, in fp32 only (fp32 FMAs, no TF32; bf16 runs on the tensor
// cores: attention_fwd_tc.cuh, attention_fwd_tc_wide.cuh), on register
// micro-tiles, with thread-block clusters that split Dh where one block
// cannot hold the head: the kernel template and its C entry point. Each
// source defines MMU_FWD_PLAIN_DIMS before including this header and holds
// the fp32 instances it names (no dropout):
//   * attention_fwd_256.cu   Dh 256 in fp32 (FLAVA fusion's default 3 heads),
//                            one block a row tile; bf16 runs on the tensor
//                            cores, attention_fwd_tc_256.cu;
//   * attention_fwd_wide.cu  Dh 384, 768 in fp32 (clusters of 2 and 4
//                            blocks); bf16 runs on the tensor cores,
//                            attention_fwd_tc_wide.cuh.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_fwd_impl
// :777 (body _attn_kernel_hl) and _sdpa_flash_fwd_impl :1071 (body
// _attn_kernel_flash_fwd) at FLAVA fusion's 3, 2 and 1 heads of D=768: the
// JAX package keeps S=320 on the whole-sequence kernel and takes the flash
// kernel at S=736 and at Dh=768. attention_flash reaches the same at any S.
//
// Function and contract: those of attention_fwd_tc.cuh, in fp32. Per (batch,
// head) out = softmax_fp32(q k^T / sqrt(Dh) + bias) v with bias 0 for kept
// keys and the finite -1e30 for masked ones, so a row whose keys are all
// masked averages V uniformly (and its lse is m + log l = -1e30 in fp32,
// which the backward kernels read as "fully masked"); keys past S weigh
// exactly 0. Scores, P and P.V are fp32. lse (B, H, S) fp32 = m + log l per row, or NULL. q, k, v
// are read through base pointers with one row stride (the packed (B, S, 3D)
// projection in place), out is dense (B, S, D); 64-bit offsets, any S.
//
// What bounds the work: the fp32 FMA units. 4 B S^2 D flops, nothing
// recomputed: 10.07 GFLOP at B=32, S=320, D=768, 0.150 ms at 67 TFLOP/s; the
// bytes (4 B S D itemsize) are a twentieth of that. Measured on an H100 80GB
// HBM3 at 700 W (tools/bench_attention.py, that shape, fp32): 0.53 / 0.42 ms
// at Dh 768 / 384, 28-36 % of the fp32 rate; 0.40 ms at Dh 256 (38 %), 1.84
// at S=736.
//
// Design (the forward twin of attention_bwd_wide.cuh's backward). An
// instance is (N, C, R): a cluster of N blocks owns R query rows, each block
// a C-column slice of Dh = N C (Wide<DH> below). At Dh=768 a block cannot
// keep 64 query rows of q and a double-buffered K / V ring in shared memory,
// nor their output in registers, so clusters of N = Dh / 192 blocks split
// it; at Dh=256 one block holds the head (N = 1: the cluster barrier, the
// remote reads and the last barrier compile out, and a block sums its two
// halves' partials locally). A block:
//   * keeps its slice of q in shared memory; K and V slices stream in 32-key
//     tiles through a two-stage cp.async ring, the next tile's loads issued
//     as soon as every thread is past the previous tile's products;
//   * scores: each block computes the R x 32 partial score tile over its
//     slice in 4 x R/16 register micro-tiles (rows x keys), the slice's
//     chunks split between the two halves of the block, whose partials are
//     summed through shared memory and published (two buffers, by tile
//     parity); one rendezvous a tile follows (barrier.cluster; N = 1:
//     __syncthreads);
//   * softmax: every block computes the softmax of all R rows, one warp a
//     row and one lane a key: it sums the N partials in rank order
//     (distributed shared memory; the same order in every block and run, so
//     every block gets the same P), applies the scale, the mask bias and the
//     -inf of keys past S, and keeps the running (m, l) in registers; P
//     (unnormalised) and each row's rescale
//     factor alpha stay in the block. A block reads the other buffer of
//     partials only after the next rendezvous, which every block reaches
//     after its reads of this tile's: no second barrier;
//   * products: each thread rescales its kPI x kPJ accumulators (rows x
//     16-byte chunks, 256 / GC row groups x GC chunk groups: 4 x 12 floats
//     at C = 192, 8 x 8 at C = 256) by alpha and adds P . V over the tile;
//   * at the end (N > 1: after a last barrier, so that no block leaves while
//     another reads its partials) each block scales by 1/l and stores its C
//     output columns; block 0 of the cluster writes lse.
// Shared memory: R C q + 2 x 2 x 32 C stream ring + 3 x R x 32 partials and P (P first the second half's partial
// scores) + row and key info: 169 KB at (C, R) = (192, 64), 217 KB at (256,
// 64); one block an SM. Where the time goes at Dh=768 (parts removed one at
// a time): the products ~30 %, the scores ~30 % (each at about half the FMA
// rate with 8 warps an SM), the softmax ~15 %, the cluster barrier and the
// remote reads ~7 % each. Left for later: 64-key tiles (half the barriers
// and softmax rounds), more warps an SM.
#pragma once
#include "attention_cluster.cuh"

namespace {

// The instance of one head dim: N blocks a cluster, C columns a block, R
// query rows; GC chunk groups of the product micro-tiles (256 / GC row
// groups).
template <int DH>
struct Wide;
template <>
struct Wide<256> {  // attention_fwd_256.cu says why this shape
  static constexpr int N = 1, C = 256, R = 64, GC = 32;
};
template <>
struct Wide<384> {
  static constexpr int N = 2, C = 192, R = 64, GC = 16;
};
template <>
struct Wide<768> {
  static constexpr int N = 4, C = 192, R = 64, GC = 16;
};

template <int N, int C, int R, int GC>
struct Shape {
  static_assert(C % 8 == 0 && (R == 32 || R == 64), "no such shape");
  static constexpr int kChunks = C / 4;        // 16-byte fp32 chunks of a slice row
  static constexpr int kLd = pitch<C>();       // floats a slice row takes in shared memory
  static constexpr int kTileFloats = 2 * kT * kLd;  // K and V of one streamed tile
  // scores: 4 rows (rg + kRG i) x kMJ keys (tg + kTG j) a thread, 128 threads
  // a half of the slice
  static constexpr int kMJ = R / 16;
  static constexpr int kRG = R / 4;
  static constexpr int kTG = kT / kMJ;
  // products: kPI rows (prg + kGR i) x kPJ chunks (pcg + GC j) a thread
  static constexpr int kGR = kThreads / GC;
  static constexpr int kPI = R / kGR;
  static constexpr int kPJ = kChunks / GC;
  static_assert(kThreads % GC == 0 && R % kGR == 0 && kChunks % GC == 0,
                "the product micro-tiles must tile R x C");
  static constexpr int kRowsPerWarp = R / kWarps;  // softmax rows of a warp
  // q, the stream ring, the partial scores (two buffers), P, alpha, 1 / l, the keys' bias
  static constexpr int kBytes =
      (R * kLd + 2 * kTileFloats + 3 * R * kT + 2 * R + 2 * kT) * (int)sizeof(float);
};

// Float offset of (row, key) in the partial-score tile [R][kT]: the key index
// is permuted by the row so that the rows of a warp's micro-tile stores (32 /
// kTG of them, kTG neighbouring keys each) hit distinct banks.
template <int kTG>
__device__ __forceinline__ int at_part(int r, int t) {
  return r * kT + (t ^ ((r % (kT / kTG)) * kTG));
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, long long row_stride,
                          const uint8_t* __restrict__ mask, float* __restrict__ out,
                          float* __restrict__ lse, int S, int H, float scale) {
  constexpr int N = Wide<DH>::N, C = Wide<DH>::C, R = Wide<DH>::R, GC = Wide<DH>::GC;
  using Sh = Shape<N, C, R, GC>;
  constexpr int kLd = Sh::kLd, kTileFloats = Sh::kTileFloats;
  constexpr int kMJ = Sh::kMJ, kRG = Sh::kRG, kTG = Sh::kTG;
  constexpr int kPI = Sh::kPI, kPJ = Sh::kPJ, kGR = Sh::kGR;
  constexpr int kRowsPerWarp = Sh::kRowsPerWarp;
  extern __shared__ __align__(128) float smem[];
  float* qs = smem;                          // [R][kLd]
  float* stream = qs + R * kLd;              // [2 stages][K, V][kT][kLd]
  float* part = stream + 2 * kTileFloats;    // [2 tiles][R][kT] (at_part): the partial scores
  float* P = part + 2 * R * kT;              // [R][kT] (at<kT>): P; first half 1's partials
  float* alpha = P + R * kT;                 // [R]: each row's rescale factor of this tile
  float* inv_l = alpha + R;                  // [R]: 1 / l at the end
  float* kbias = inv_l + R;                  // [2 stages][kT]: each key's bias, -inf past S

  int rank = 0, r0 = blockIdx.x * R;
  if constexpr (N > 1) {
    rank = (int)cluster_rank();
    r0 = (int)cluster_id() * R;
  }
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long col = (long long)h * DH + rank * C;  // this block's slice of the head
  const long long qkv_off = (long long)b * S * row_stride + col;
  const uint8_t* key_mask = mask ? mask + (long long)b * S : nullptr;
  const float* kb = k + qkv_off;
  const float* vb = v + qkv_off;

  auto prefetch = [&](int stage, int t0) {
    float* st = stream + stage * kTileFloats;
    load_rows<kT, C>(st, kb, row_stride, t0, S);
    load_rows<kT, C>(st + kT * kLd, vb, row_stride, t0, S);
    if (tid < kT) {
      const int s = t0 + tid;
      kbias[stage * kT + tid] = s >= S ? -INFINITY : key_mask && !key_mask[s] ? kMaskBias : 0.f;
    }
    cp_async_commit();
  };

  load_rows<R, C>(qs, q + qkv_off, row_stride, r0, S);
  prefetch(0, 0);

  // score roles: half hf of the slice's chunks; rows rg + kRG i, keys tg + kTG j
  const int hf = warp / 4, i128 = tid % 128;
  const int rg = i128 / kTG, tg = i128 % kTG;
  // product roles: rows prg + kGR i (i < kPI), the slice's chunks pcg + GC j (j < kPJ)
  const int prg = tid / GC, pcg = tid % GC;
  // softmax roles: this warp's rows
  const int orow0 = warp * kRowsPerWarp;

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_run[rr] = -INFINITY;
    l_run[rr] = 0.f;
  }
  float4 acc[kPI][kPJ];
#pragma unroll
  for (int i = 0; i < kPI; ++i)
#pragma unroll
    for (int j = 0; j < kPJ; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  float* scratch = P;  // half 1's partials
  const int n_tiles = (S + kT - 1) / kT;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile it (and, at it = 0, q) is in; tile it - 1 is consumed
    if (it + 1 < n_tiles) prefetch(stage ^ 1, (it + 1) * kT);
    const float* K = stream + stage * kTileFloats;
    const float* V = K + kT * kLd;

    // this thread's partial scores over its half of the slice
    float x[4][kMJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kMJ; ++j) x[i][j] = 0.f;
#pragma unroll 8
    for (int c = hf * (Sh::kChunks / 2); c < (hf + 1) * (Sh::kChunks / 2); ++c) {
      float4 kj[kMJ];
#pragma unroll
      for (int j = 0; j < kMJ; ++j) kj[j] = ld4(K + at<C>(tg + kTG * j, c));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qi = ld4(qs + at<C>(rg + kRG * i, c));
#pragma unroll
        for (int j = 0; j < kMJ; ++j) x[i][j] = dot4(qi, kj[j], x[i][j]);
      }
    }
    if (hf) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kMJ; ++j) scratch[(i * kMJ + j) * 128 + i128] = x[i][j];
    }
    float* pt = part + (it & 1) * R * kT;  // this tile's partials
    __syncthreads();
    if (!hf) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kMJ; ++j)
          pt[at_part<kTG>(rg + kRG * i, tg + kTG * j)] =
              x[i][j] + scratch[(i * kMJ + j) * 128 + i128];
    }
    // every block's partials of this tile are published; every block is past the previous
    // tile's reads of them, so the next tile may overwrite the other buffer
    rendezvous<N>();

    // the softmax of all the rows, the same in every block: a warp a row, a lane a key
    const float bias = kbias[stage * kT + lane];
    float sum[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      if constexpr (N == 1) {
        sum[rr] = pt[at_part<kTG>(orow0 + rr, lane)];
      } else {
        const uint32_t pa = smem_u32(pt + at_part<kTG>(orow0 + rr, lane));
        sum[rr] = 0.f;
#pragma unroll
        for (int r = 0; r < N; ++r) sum[rr] += ld_cluster(pa, r);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int row = orow0 + rr;
      const float sc = sum[rr] * scale + bias;  // -inf past S
      const float m_new = fmaxf(m_run[rr], warp_max(sc));
      const float a = expf(m_run[rr] - m_new);  // 0 on the first tile
      const float e = expf(sc - m_new);
      l_run[rr] = l_run[rr] * a + warp_sum(e);
      m_run[rr] = m_new;
      P[at<kT>(row, lane / 4) + lane % 4] = e;
      if (lane == 0) alpha[row] = a;
    }
    __syncthreads();  // P and alpha of this tile are in
    // acc = acc * alpha + P . V over the tile
#pragma unroll
    for (int i = 0; i < kPI; ++i) {
      const float al = alpha[prg + kGR * i];
#pragma unroll
      for (int j = 0; j < kPJ; ++j) {
        acc[i][j].x *= al;
        acc[i][j].y *= al;
        acc[i][j].z *= al;
        acc[i][j].w *= al;
      }
    }
#pragma unroll
    for (int c4 = 0; c4 < kT / 4; ++c4) {
      float4 w4[kPI];
#pragma unroll
      for (int i = 0; i < kPI; ++i) w4[i] = ld4(P + at<kT>(prg + kGR * i, c4));
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const int t = 4 * c4 + tt;
        float4 y[kPJ];
#pragma unroll
        for (int j = 0; j < kPJ; ++j) y[j] = ld4(V + at<C>(t, pcg + GC * j));
#pragma unroll
        for (int i = 0; i < kPI; ++i)
#pragma unroll
          for (int j = 0; j < kPJ; ++j) fma4(acc[i][j], comp(w4[i], tt), y[j]);
      }
    }
  }

  if constexpr (N > 1) cluster_sync();  // no block reads another's shared memory after this

  // 1 / l of each row; block 0 of the cluster writes lse
  const long long stat_off = ((long long)b * H + h) * S;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = orow0 + rr;
    if (lane == 0) {
      inv_l[row] = 1.f / l_run[rr];
      if (lse != nullptr && rank == 0 && r0 + row < S)
        lse[stat_off + r0 + row] = m_run[rr] + logf(l_run[rr]);
    }
  }
  __syncthreads();

  const int D = H * DH;
  float* o = out + (long long)b * S * D + col;
#pragma unroll
  for (int i = 0; i < kPI; ++i) {
    const int row = prg + kGR * i;
    const int s = r0 + row;
    if (s >= S) continue;
    const float il = inv_l[row];
#pragma unroll
    for (int j = 0; j < kPJ; ++j)
      store4(o + (long long)s * D + 4 * (pcg + GC * j),
             make_float4(acc[i][j].x * il, acc[i][j].y * il, acc[i][j].z * il,
                         acc[i][j].w * il));
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, long long row_stride,
                   const void* mask, void* out, float* lse, int B, int S, int H,
                   cudaStream_t stream) {
  using W = Wide<DH>;
  static_assert(W::N * W::C == DH, "a cluster's slices make the head");
  constexpr int smem = Shape<W::N, W::C, W::R, W::GC>::kBytes;
  static_assert(smem <= 227 * 1024, "one block of this shape fits an SM's shared memory");
  const dim3 grid(((S + W::R - 1) / W::R) * W::N, H, B);
  return launch_clusters<W::N>(attention_fwd_wide_kernel<DH>, grid, kThreads, smem, stream,
                               static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), row_stride,
                               static_cast<const uint8_t*>(mask), static_cast<float*>(out), lse, S,
                               H, (float)(1.0 / sqrt((double)DH)));  // rounded as 1.0 / dh**0.5 is
}

// The launch of the instance whose head dim is dh, among DHS; an invalid
// value when this library has none.
template <int... DHS>
cudaError_t dispatch(Dims<DHS...>, int dh, const void* q, const void* k, const void* v,
                     long long row_stride, const void* mask, void* out, float* lse, int B,
                     int S, int H, cudaStream_t stream) {
  if (row_stride % 4) return cudaErrorInvalidValue;  // 16-byte rows
  cudaError_t err = cudaErrorInvalidValue;
  (void)((dh == DHS &&
          ((err = launch<DHS>(q, k, v, row_stride, mask, out, lse, B, S, H, stream)), true)) ||
         ...);
  return err;
}

}  // namespace

// Plain C entry point (loaded with ctypes), the signature of
// attention_fwd_tc32.cuh's. dtype: 0 = float32 (the only one; bf16 runs on the
// tensor cores); dh: one of MMU_FWD_PLAIN_DIMS.
// q, k, v: (B, S, D) views with row stride row_stride (whole 16-byte words,
// 16-byte aligned bases); mask: (B, S) bytes, nonzero = key kept, or NULL;
// keep must be NULL (no dropout instance at these head dims); out: dense
// (B, S, D); lse: (B, H, S) float32 or NULL. Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for anything this library has no instance of).
extern "C" int mmu_attention_fwd(const void* q, const void* k, const void* v,
                                 long long row_stride, const void* mask, const void* keep,
                                 float inv_keep, void* out, void* lse, int B, int S, int H,
                                 int dh, int dtype, int device, void* stream) {
  (void)inv_keep;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (keep != nullptr || B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch(Dims<MMU_FWD_PLAIN_DIMS>(), dh, q, k, v, row_stride, mask, out,
                       static_cast<float*>(lse), B, S, H, static_cast<cudaStream_t>(stream));
}
