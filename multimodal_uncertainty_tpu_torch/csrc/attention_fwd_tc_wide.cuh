// Masked multi-head attention forward for Hopper (sm_90a) in bf16 at the
// widest head dims, Dh 384 and 768, without dropout, on the tensor cores: the
// kernel template and its C entry point. Each source defines MMU_FWD_TC_DH
// before including this header, so the two compile in separate nvcc
// processes, started together (ops/_build.py):
//   * attention_fwd_tc_384.cu  Dh 384 (FLAVA fusion at 2 heads of D=768);
//   * attention_fwd_tc_768.cu  Dh 768 (FLAVA fusion at 1 head).
// fp32 at these head dims stays on the cluster kernel of
// attention_fwd_wide.cuh (ops/attention.py::fwd_source).
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_fwd_impl
// :777 (K1, pallas_call :788, body _attn_kernel_hl :348) and
// _sdpa_flash_fwd_impl :1071 (K3, pallas_call :1087, body
// _attn_kernel_flash_fwd :1000) in bf16 at 2 and 1 heads of 768: the JAX
// package keeps S = 320 on the whole-sequence kernel and takes the flash
// kernel at S = 736 and at Dh = 768.
//
// Function and contract: those of attention_fwd_tc.cuh, unchanged. Per
// (batch, head): out = softmax_fp32(q k^T / sqrt(Dh) + bias) v, bias 0 for
// kept keys and the finite -1e30 for masked ones (a fully masked row
// averages V uniformly and writes lse exactly -1e30), keys past S weigh
// exactly 0; logits and P.V sum in fp32, the unnormalised P is rounded to
// bf16 before P.V and the row sum taken before that rounding; lse = m + ln(l)
// (B, H, S) fp32. q, k, v are read through base pointers with one row stride
// (the packed (B, S, 3D) projection in place); out is dense (B, S, D); 64-bit
// offsets, any S with no padding. The scale is 1 / sqrt(Dh) of the whole
// head (scale_of<DH>), whatever slice a block holds.
//
// What bounds it: the bytes at short S. At FLAVA's B=32, S=320, D=768 the
// operands and the output (4 B S D x 2 bytes) take 0.0188 ms at 3.35 TB/s and
// the 4 B S^2 D = 10.1 GFLOP 0.0102 ms at 989 TFLOP/s.
//
// Design. 64 query rows x Dh of O do not fit a warpgroup's registers (384
// fp32 a thread at Dh 768), so the head is split into C = 192-column slices
// of O: a cluster of N = Dh / C blocks (2 at Dh 384, 4 at 768) owns 128
// query rows, each block one slice, each of its two warpgroups 64 rows x 192
// in 96 accumulators a thread (one m64n192k16 a k16 step of P.V, across
// three 64-column panels). Every block needs all of its rows' scores, which
// sum over all of Dh: each computes the partial scores over its own slice of
// q (in shared memory) and k (12 k16 steps), writes them to its shared
// memory in its threads' accumulator order, and after one barrier.cluster
// reads the N partials through distributed shared memory and sums them in
// rank order 0 .. N-1, its own included from shared memory: the same order in
// every block, so every block forms the same P bit for bit (fp32 addition
// does not associate) and block 0's lse matches every block's slice. Two
// buffers of partials by tile parity: a block overwrites a buffer two tiles
// later, after the next barrier, which every block reaches only past its
// reads of this one. A last barrier keeps every block alive until no block
// reads its buffers. The rest is attention_fwd_tc.cuh's: K and V slices of
// 64 keys through a two-stage cp.async ring in 64-column panels of 128-byte
// rows in the 128-byte swizzle (rows past S zero-filled), the online softmax
// in the exp2 domain on the accumulators (row max and rescale shared by a
// row's four threads through two shuffles), P rounded to bf16 straight back
// as the register A operand of O += P v_slice. A warpgroup whose rows all lie
// past S skips its products but keeps every barrier. Shared memory: q 48 KB,
// the ring 96 KB, the partials 64 KB: one block an SM. The sources' headers
// give the times of the shapes this one was raced against, removed with
// their code (q in registers, 32-key tiles, and blocks that each score over
// all of Dh with no cluster).
// Left for later: TMA and a deeper ring, a reduce-scatter of the partials
// (each block summing 1/N of them) instead of N remote reads a position.
#pragma once
#include "attention_tc.cuh"
#include "cluster.cuh"

namespace {

// The block's layout at head dim DH: output slices of C = 192 columns, N =
// DH / C blocks a cluster, 128 query rows (64 a warpgroup), 64-key tiles.
template <int DH>
struct FwdTcWide {
  static_assert(DH == 384 || DH == 768, "the head dims of FLAVA fusion at 2 and 1 heads");
  static constexpr int C = 192;                    // output columns a block owns
  static constexpr int N = DH / C;                 // blocks a cluster
  static constexpr int kRows = 128;                // query rows a cluster owns
  static constexpr int BT = 64;                    // keys a streamed tile
  static constexpr int kPanels = C / 64;           // 64-column panels of a slice row
  static constexpr int kSteps = C / 16;            // k16 steps of the partial scores
  static constexpr int kQBytes = kPanels * kRows * 128;
  static constexpr int kTileBytes = kPanels * BT * 128;           // a K or V slice tile
  static constexpr int kPartBytes = kRows * BT * 4;               // a tile's partial scores
  static constexpr int kPartOff = kQBytes + 4 * kTileBytes;       // after [stage][k, v]
  static constexpr int kInfoOff = kPartOff + 2 * kPartBytes;
  static constexpr int kSmem = 1024 + kInfoOff + 2 * BT * 4;      // + alignment slack
  static_assert(N * C == DH && kSmem <= 232448, "one block's shared memory");
};

// The P::kRows query rows of one (batch, head) and the C columns of O of the
// block's rank in its cluster, looping over key tiles.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_tc_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, long long row_stride,
                             const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                             float* __restrict__ lse, int S, int H) {
  using P = FwdTcWide<DH>;
  constexpr int C = P::C, N = P::N, BT = P::BT;
  constexpr float kScaleLog2 = scale_of<DH>() * kLog2e;  // the whole head's 1 / sqrt(Dh)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t at = smem_u32(smem_raw);
  // [q], the ring's [stage][k, v] tiles, [2] partial-score buffers, [stage][key] biases
  const uint32_t qs = (at + 1023) & ~1023u;
  const uint32_t ring = qs + P::kQBytes, part = qs + P::kPartOff;
  uint8_t* base = smem_raw + (qs - at);
  float4* part_ptr = reinterpret_cast<float4*>(base + P::kPartOff);
  // a key's exponent bias in the exp2 domain: 0 if kept, the masked -1e30 log2(e), -inf past S
  float* kbias = reinterpret_cast<float*>(base + P::kInfoOff);

  const int rank = (int)cluster_rank();
  const int q0 = (int)cluster_id() * P::kRows, h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = 64 * wg;  // the warpgroup's rows in the block
  const int D = H * DH;
  const int c0 = rank * C;  // the block's slice of the head's columns
  const long long head_off = (long long)b * S * row_stride + (long long)h * DH + c0;
  const uint8_t* key_mask = mask ? mask + (long long)b * S : nullptr;

  auto prefetch = [&](int stage, int k0) {
    const uint32_t kt = ring + 2 * stage * P::kTileBytes;
    load_rows<C, BT>(kt, k + head_off, row_stride, k0, S);
    load_rows<C, BT>(kt + P::kTileBytes, v + head_off, row_stride, k0, S);
    if (threadIdx.x < BT) {
      const int key = k0 + threadIdx.x;
      kbias[stage * BT + threadIdx.x] =
          key >= S ? -INFINITY : (key_mask && !key_mask[key] ? kMaskBias2 : 0.f);
    }
    cp_async_commit();
  };
  load_rows<C, P::kRows>(qs, q + head_off, row_stride, q0, S);  // in the first group
  prefetch(0, 0);

  const int lo = q0 + row0 + warp * 16 + g, hi = lo + 8;
  const bool live = q0 + row0 < S;  // the same for the whole warpgroup
  const uint32_t qs_own = qs + row0 * 128;

  // per row (lo, hi): the running max (exp2 domain) and this thread's part of
  // the running sum (its BT / 4 of the tile's BT columns)
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[C / 8][4];
  zero_n(acc);
  const int n_tiles = (S + BT - 1) / BT;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      prefetch(stage ^ 1, (it + 1) * BT);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t ks = ring + 2 * stage * P::kTileBytes, vs = ks + P::kTileBytes;
    float sc[BT / 8][4];
    if (live) {  // this slice's part of S = q k^T
      zero_n(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P::kSteps; ++kk)
        wgmma_ss<0>(sc, desc_k<P::kRows>(qs_own, kk), desc_k<BT>(ks, kk));
      wgmma_commit();
      fence_n(sc);
      wgmma_wait();
      fence_n(sc);
    }
    // publish this thread's partials (float4 j of thread t at j kThreads + t), then sum
    // every block's in rank order, this block's own read back the same way
    const int buf = it & 1;
    if (live) {
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
        part_ptr[(buf * (BT / 8) + j) * kThreads + threadIdx.x] =
            make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
    }
    cluster_sync();  // every block's partials of this tile are in
    if (live) {
      zero_n(sc);
#pragma unroll
      for (int r = 0; r < N; ++r)
#pragma unroll
        for (int j = 0; j < BT / 8; ++j) {
          const float4 x =
              ld_cluster4(part + 16 * ((buf * (BT / 8) + j) * kThreads + threadIdx.x), r);
          sc[j][0] += x.x;
          sc[j][1] += x.y;
          sc[j][2] += x.z;
          sc[j][3] += x.w;
        }
    }
    if (live) {
      // logits in the exp2 domain, the tile's row max, the rescale of the old state
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = fmaf(sc[j][e], kScaleLog2, kbias[stage * BT + 8 * j + 2 * t4 + (e & 1)]);
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(mx[r]));  // finite: every tile has a key < S
        alpha[r] = ex2(m_run[r] - m_new);                       // 0 on the first tile
        m_run[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(sc[j][e] - m_run[e >> 1]);
          sc[j][e] = p;
          rs[e >> 1] += p;
        }
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = fmaf(l_run[r], alpha[r], rs[r]);

      uint32_t pa[BT / 16][4];
      to_a_n(sc, pa);  // the unnormalised P, rounded to bf16
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk)  // O += P v_slice
        wgmma<1>(acc, pa[kk], desc_mn<BT, P::kPanels>(vs, 0, kk));
      wgmma_commit();
      fence_n(acc);
      wgmma_wait();  // the tiles are read: the next prefetch may overwrite them
      fence_n(acc);
    }
    __syncthreads();
  }
  cluster_sync();  // no block reads another's partials past this
  if (!live) return;

  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] = quad_sum(l_run[r]);
    inv_l[r] = 1.f / l_run[r];
  }
  bf16* o = out + (long long)b * S * D + (long long)h * DH + c0;
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (lo < S)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)lo * D + col) =
          __floats2bfloat162_rn(acc[j][0] * inv_l[0], acc[j][1] * inv_l[0]);
    if (hi < S)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)hi * D + col) =
          __floats2bfloat162_rn(acc[j][2] * inv_l[1], acc[j][3] * inv_l[1]);
  }
  if (lse != nullptr && rank == 0 && t4 == 0) {
    const long long stat_off = ((long long)b * H + h) * S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? hi : lo;
      // a fully masked row (its max is the masked bias) is -1e30 + ln(S) = -1e30 in fp32
      if (row < S)
        lse[stat_off + row] = m_run[r] <= 0.5f * kMaskBias2 ? kMaskBias
                                                            : m_run[r] * kLn2 + logf(l_run[r]);
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes), the signature of
// attention_fwd_tc.cuh's; bf16 only, Dh = MMU_FWD_TC_DH, no dropout (a keep
// mask is refused). q, k, v: (B, S, H * Dh) views with row stride row_stride
// (a multiple of 8 elements, 16-byte aligned bases); mask: (B, S) bytes,
// nonzero = key kept, or NULL for all kept; out: dense (B, S, H * Dh) bf16;
// lse: (B, H, S) float32 or NULL. Returns the cudaError_t of the launch.
extern "C" int mmu_attention_fwd_tc(const void* q, const void* k, const void* v,
                                    long long row_stride, const void* mask, const void* keep,
                                    float, void*, void* out, void* lse, int B, int S, int H,
                                    int device, void* stream) {
  constexpr int DH = MMU_FWD_TC_DH;
  using P = FwdTcWide<DH>;
  auto kernel = attention_fwd_tc_wide_kernel<DH>;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || S < 1 || H < 1 || row_stride % 8 || keep != nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_clusters<P::N>(kernel, dim3((S + P::kRows - 1) / P::kRows * P::N, H, B), kThreads,
                               P::kSmem, static_cast<cudaStream_t>(stream),
                               static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                               static_cast<const bf16*>(v), row_stride,
                               static_cast<const uint8_t*>(mask), static_cast<bf16*>(out),
                               static_cast<float*>(lse), S, H);
}
