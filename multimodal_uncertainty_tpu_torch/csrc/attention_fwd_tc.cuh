// Masked multi-head attention forward for Hopper (sm_90a) in bf16 on the
// tensor cores, without dropout and (DROPOUT) with BERT's attention-probs
// dropout: the kernel template and its C entry point. Each source defines
// MMU_FWD_TC_DH and its shape (MMU_FWD_TC_SHAPE, below; MMU_FWD_TC_DROPOUT
// where it holds the dropout instance too) before including this header, so
// the instances compile in separate nvcc processes, started together
// (ops/_build.py), one head dim a library:
//   * attention_fwd_tc.cu      Dh 64  (MMBT's, ViLT's and BERT's 12 heads, K4;
//                                      with dropout: K5, MMBT's
//                                      --attention_probs_dropout);
//   * attention_fwd_tc_24.cu   Dh 24  (FLAVA fusion at 32 heads);
//   * attention_fwd_tc_48.cu   Dh 48  (FLAVA fusion at 16 heads);
//   * attention_fwd_tc_k6.cu   Dh 96  (FLAVA fusion at 8 heads);
//   * attention_fwd_tc_192.cu  Dh 192 (FLAVA fusion at 4 heads);
//   * attention_fwd_tc_256.cu  Dh 256 (FLAVA fusion's default 3 heads).
//   * attention_fwd_tc_32.cu   Dh 32  (FLAVA fusion at 24 heads, the tiny
//                                      BERT; with dropout: K5 at --tiny);
//   * attention_fwd_tc_128.cu  Dh 128 (FLAVA fusion at 6 heads).
// Dh 384 and 768 run on clusters (attention_fwd_tc_wide.cuh); fp32 as split
// fp32 (attention_fwd_tc32.cuh) or on the micro-tile / cluster kernel
// (attention_fwd_wide.cuh; ops/attention.py::fwd_source).
//
// Replaces these Pallas TPU kernels of multimodal_uncertainty_tpu/ops/attention.py
// in bf16 (each source names its own):
//   * _sdpa_flash_fwd_stream_impl :1488 (body _attn_kernel_flash_fwd_stream
//     :1318): the long-context forward (K4, reached through attention_flash);
//   * _sdpa_packed_fwd_impl :777 (body _attn_kernel_hl :348),
//     _sdpa_flash_fwd_impl :1071 (body _attn_kernel_flash_fwd :1000) and
//     _sdpa_hl_fwd_impl :419 (K1, K3, K2 fwd);
//   * _sdpa_pallas_fwd_impl :160 (body _attn_kernel :118; K6), which the TPU
//     runs heads-first at Dh 24, 48, 96 and 192; here the heads-last rows are
//     read in place;
//   * _sdpa_hl_drop_fwd_impl :677 (pallas_call :689, body _attn_kernel_hl_drop
//     :563; K5): the forward with dropout on the attention probabilities (the
//     DROPOUT instance).
//
// Function and contract: the plain version's (ops/attention.py::
// attention_fwd_plain). Per (batch,
// head): out = softmax_fp32(q k^T / sqrt(Dh) + bias) v, with bias = 0 for
// kept keys and the finite -1e30 for masked ones, so a row whose keys are all
// masked averages V uniformly over all S keys; keys past S (the ragged last
// tile) weigh exactly 0. Logits and P.V sum in fp32; the unnormalised P is
// rounded to bf16 before P.V, the row sum l is taken before that rounding.
// lse = m + ln(l) per row, (B, H, S) fp32 in
// natural log; a fully masked row writes exactly -1e30 (what the plain
// version gives, m + ln(S) rounding to m), which both
// backwards read as "uniform row" (lse <= -5e29). q, k, v are read through
// base pointers with one row stride (the packed (B, S, 3D) projection in
// place); out is dense (B, S, D); 64-bit offsets, any S with no padding.
// Dropout (DROPOUT; attention_fwd_tc32.cuh's contract): l and lse stay
// un-dropped, only P.V takes keep ? e inv_keep : 0, the unnormalised P is
// rounded to bf16 after the keep factor; the uint8 (B, H, S, S) keep mask,
// drawn outside the kernel, is indexed [query][key]. A first launch packs it
// into row words in the caller's scratch (pack_keep: bit i of word w of query
// q is key 32 w + i, zero past S; a warp packs 32 x 32 bytes by coalesced
// loads and ballots), and each thread turns the 2 words a row of its two rows
// into the 32 keep bits of its accumulator elements of a 64-key tile,
// loaded before it waits for the tile. The mask (10.45 MB at B=32, S=165, 12
// heads) is read once.
//
// What bounds it: 4 B S^2 D flops on the bf16 tensor cores and one exp2 per
// score on the SFU, or the bytes (4 B S D x 2 + the fp32 lse) at short S. At
// K4's row (B=1, S=16384, 12 x 64) that is 825 GFLOP, 0.83 ms at 989
// TFLOP/s, and 3.2e9 exponentials, ~0.9 ms at the SFU's 16 a clock per SM; at
// FLAVA's B=128, S=320, D=768 the bytes take 0.075 ms at 3.35 TB/s and the
// flops 0.041 ms; at S = 736 the flops 0.215 ms. At the narrow head dims the
// exponentials bound it, not the products: B H S^2 of them whatever Dh, so at
// Dh 24 (32 heads) B=128, S=320 takes 4.2e8, 0.11 ms at the SFU's 16 a clock
// per SM, against 0.01 ms of products.
//
// Design (FA2's forward on Hopper's warpgroup products, from the pieces it
// shares with attention_bwd_tc.cuh in attention_tc.cuh):
//   * a block is two warpgroups owning 64 query rows each, 128 a block, and
//     all Dh columns of their output. A warpgroup whose rows all lie past S
//     skips its products (the last row block of a ragged S);
//   * the block's q rows are loaded once: as the register A fragments of
//     wgmma (AREG 1, Dh / 4 registers a thread) or, where registers are short,
//     as a shared-memory tile that wgmma reads as A through a descriptor
//     (AREG 0);
//   * K and V come in BT-row tiles through a two-stage cp.async ring, rows
//     past S zero-filled by the copy, in 64-column panels of 128-byte rows
//     (Dh 96 pads its second panel, Dh 24 and 48 their one; the padding past
//     Dh rounded up to 16 is never read, Dh 24's chunk 24..31 is zero-filled).
//     The K tile is a K-major B operand (S = q k^T: n = key, k = Dh in
//     ceil(Dh / 16) k16 steps), the V tile an MN-major one (O += P v: k = key,
//     n = Dh, one m64nNk16 a step across the panels by the leading-byte
//     offset);
//   * S goes into fp32 accumulators; the online softmax runs on them in the
//     exp2 domain (scale and log2(e) folded into one FMA with the key's bias:
//     0, the masked -1e30 log2(e), or -inf past S), the row max and the
//     rescale factor shared by the four threads of a row through two
//     shuffles; the row sum stays a per-thread partial until the end. P,
//     rounded to bf16, goes straight back as the register-A operand of
//     O += P v (the accumulator layout is the register-A layout): P never
//     touches shared memory.
// Each source's header gives its shape and the times of the shapes it was
// raced against.
// Left for later: TMA and a deeper ring, overlapping one tile's softmax with
// the other warpgroup's products (FA3's ping-pong), one producer warp.
#pragma once
#include "attention_tc.cuh"

namespace {

// The forward's shape at head dim DH: BT keys a streamed tile, q in registers
// (AREG 1) or shared memory (0), MINB blocks an SM. A source names it as
// MMU_FWD_TC_SHAPE ("BT, AREG, MINB").
template <int DH, int BT, int AREG, int MINB>
struct FwdTc {
  static_assert(DH == 24 || DH == 32 || DH == 48 || DH == 64 || DH == 96 || DH == 128 ||
                    DH == 192 || DH == 256,
                "a head dim with a wgmma width n = Dh and its scale_of");
  static_assert(BT == 32 || BT == 64, "streamed tiles of 32 or 64 keys");
  static constexpr int kPanels = (DH + 63) / 64;   // 64-column panels a row
  static constexpr int kSteps = (DH + 15) / 16;    // k16 steps over Dh
  static constexpr int kRows = 128;                // query rows a block owns, 64 a warpgroup
  static constexpr int kTileBytes = kPanels * BT * 128;                // a K or V tile
  static constexpr int kQBytes = AREG != 0 ? 0 : kPanels * kRows * 128;
  static constexpr int kInfoOff = kQBytes + 4 * kTileBytes;            // after [stage][k, v]
  static constexpr int kSmem = 1024 + kInfoOff + 2 * BT * 4;          // + alignment slack
  static_assert(kSmem <= 232448 && MINB * (kSmem + 1024) <= 233472,
                "shared memory of MINB blocks an SM");
};

// Pass 0 (DROPOUT): the keep mask's row words (pack_keep).
__global__ void __launch_bounds__(256)
attention_fwd_tc_keep_kernel(const uint8_t* __restrict__ keep, uint32_t* __restrict__ rows,
                             int S, int W) {
  pack_keep<false>(keep, rows, nullptr, S, W);
}

// The P::kRows query rows of one (batch, head), looping over key tiles.
// DROPOUT: P.V takes keep ? e inv_keep : 0 (l and lse stay un-dropped).
template <bool DROPOUT, int DH, int BT, int AREG, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
attention_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, long long row_stride,
                        const uint8_t* __restrict__ mask, const uint32_t* __restrict__ keep_rows,
                        float inv_keep, bf16* __restrict__ out, float* __restrict__ lse, int S,
                        int H) {
  using P = FwdTc<DH, BT, AREG, MINB>;
  static_assert(!DROPOUT || BT / 8 * 4 <= 32, "a tile's keep bits fit one word");
  constexpr float kScaleLog2 = scale_of<DH>() * kLog2e;  // 1 / sqrt(Dh) in the exp2 domain
  extern __shared__ uint8_t smem_raw[];
  const uint32_t at = smem_u32(smem_raw);
  const uint32_t qs = (at + 1023) & ~1023u;  // [q], then the ring's [stage][k, v] tiles
  const uint32_t ring = qs + P::kQBytes;
  // [stage][key]: the key's exponent bias in the exp2 domain: 0 if kept, the
  // masked -1e30 log2(e), -inf past S
  float* kbias = reinterpret_cast<float*>(smem_raw + (qs - at) + P::kInfoOff);

  const int q0 = blockIdx.x * P::kRows, h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = 64 * wg;  // the warpgroup's rows in the block
  const int D = H * DH;
  const long long head_off = (long long)b * S * row_stride + (long long)h * DH;
  const uint8_t* key_mask = mask ? mask + (long long)b * S : nullptr;
  const long long stat_off = ((long long)b * H + h) * S;
  const int W = (S + 31) / 32;  // (DROPOUT) keep words a row

  auto prefetch = [&](int stage, int k0) {
    const uint32_t kt = ring + 2 * stage * P::kTileBytes;
    load_rows<DH, BT>(kt, k + head_off, row_stride, k0, S);
    load_rows<DH, BT>(kt + P::kTileBytes, v + head_off, row_stride, k0, S);
    if (threadIdx.x < BT) {
      const int key = k0 + threadIdx.x;
      kbias[stage * BT + threadIdx.x] =
          key >= S ? -INFINITY : (key_mask && !key_mask[key] ? kMaskBias2 : 0.f);
    }
    cp_async_commit();
  };
  if constexpr (AREG == 0)  // in the first group, with the first tile
    load_rows<DH, P::kRows>(qs, q + head_off, row_stride, q0, S);
  prefetch(0, 0);

  const int lo = q0 + row0 + warp * 16 + g, hi = lo + 8;
  const bool live = q0 + row0 < S;  // the same for the whole warpgroup
  uint32_t qa[AREG != 0 ? P::kSteps : 1][4];
  if constexpr (AREG != 0) load_a_n<DH>(qa, q + head_off, row_stride, lo, hi, S, t4);
  const uint32_t qs_own = qs + row0 * 128;

  // per row (lo, hi): the running max (exp2 domain) and this thread's part of
  // the running sum (its BT / 4 of the tile's BT columns)
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[DH / 8][4];
  zero_n(acc);
  const int n_tiles = (S + BT - 1) / BT;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) prefetch(stage ^ 1, (it + 1) * BT);
    // (DROPOUT) this thread's keep bits of the tile, loaded before the wait
    uint32_t kept = 0u;
    if constexpr (DROPOUT) {
      if (live) kept = keep_bits<BT / 8>(keep_rows + stat_off * W, lo, hi, it * BT, S, W, t4);
    }
    if (it + 1 < n_tiles) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    const uint32_t ks = ring + 2 * stage * P::kTileBytes, vs = ks + P::kTileBytes;
    if (live) {
      float sc[BT / 8][4];
      zero_n(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P::kSteps; ++kk) {  // S = q k^T
        if constexpr (AREG != 0) wgmma<0>(sc, qa[kk], desc_k<BT>(ks, kk));
        else wgmma_ss<0>(sc, desc_k<P::kRows>(qs_own, kk), desc_k<BT>(ks, kk));
      }
      wgmma_commit();
      fence_n(sc);
      wgmma_wait();
      fence_n(sc);

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
          rs[e >> 1] += p;
          // the weight P.V takes (DROPOUT: keep ? p inv_keep : 0)
          if constexpr (DROPOUT) sc[j][e] = (kept >> (4 * j + e)) & 1u ? p * inv_keep : 0.f;
          else sc[j][e] = p;
        }
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = fmaf(l_run[r], alpha[r], rs[r]);

      uint32_t pa[BT / 16][4];
      to_a_n(sc, pa);  // the unnormalised P (DROPOUT: after the keep factor), rounded to bf16
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk)  // O += P v
        wgmma<1>(acc, pa[kk], desc_mn<BT, P::kPanels>(vs, 0, kk));
      wgmma_commit();
      fence_n(acc);
      wgmma_wait();  // the tiles are read: the next prefetch may overwrite them
      fence_n(acc);
    }
    __syncthreads();
  }
  if (!live) return;

  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] = quad_sum(l_run[r]);
    inv_l[r] = 1.f / l_run[r];
  }
  bf16* o = out + (long long)b * S * D + (long long)h * DH;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (lo < S)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)lo * D + col) =
          __floats2bfloat162_rn(acc[j][0] * inv_l[0], acc[j][1] * inv_l[0]);
    if (hi < S)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)hi * D + col) =
          __floats2bfloat162_rn(acc[j][2] * inv_l[1], acc[j][3] * inv_l[1]);
  }
  if (lse != nullptr && t4 == 0) {
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

// The forward with or without dropout (DROPOUT: first the keep mask's row
// words into keep_words).
template <bool DROPOUT>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, long long row_stride,
                       const uint8_t* mask, const uint8_t* keep, float inv_keep,
                       uint32_t* keep_words, bf16* out, float* lse, int B, int S, int H,
                       cudaStream_t st) {
  constexpr int DH = MMU_FWD_TC_DH;
  using P = FwdTc<DH, MMU_FWD_TC_SHAPE>;
  auto kernel = attention_fwd_tc_kernel<DROPOUT, DH, MMU_FWD_TC_SHAPE>;
  if constexpr (DROPOUT) {
    const int W = (S + 31) / 32;
    attention_fwd_tc_keep_kernel<<<dim3(W, (W + 7) / 8, B * H), 256, 0, st>>>(keep, keep_words, S,
                                                                             W);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + P::kRows - 1) / P::kRows, H, B);
  kernel<<<grid, kThreads, P::kSmem, st>>>(q, k, v, row_stride, mask, keep_words, inv_keep, out,
                                           lse, S, H);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes); bf16 only, Dh = MMU_FWD_TC_DH. q,
// k, v: (B, S, H * Dh) views with row stride row_stride (a multiple of 8
// elements, 16-byte aligned bases); mask: (B, S) bytes, nonzero = key kept,
// or NULL for all kept; keep: the (B, H, S, S) dropout bytes, nonzero = kept
// and scaled by inv_keep, with keep_words, (B, H, S, ceil(S / 32)) 32-bit
// scratch, or both NULL for no dropout (a source without MMU_FWD_TC_DROPOUT
// refuses a keep mask); out: dense (B, S, H * Dh) bf16; lse: (B, H, S)
// float32 of the un-dropped softmax, or NULL. Returns the cudaError_t of the
// launches.
extern "C" int mmu_attention_fwd_tc(const void* q, const void* k, const void* v,
                                    long long row_stride, const void* mask, const void* keep,
                                    float inv_keep, void* keep_words, void* out, void* lse,
                                    int B, int S, int H, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || S < 1 || H < 1 || row_stride % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* q_t = static_cast<const bf16*>(q);
  const bf16* k_t = static_cast<const bf16*>(k);
  const bf16* v_t = static_cast<const bf16*>(v);
  const uint8_t* mask_t = static_cast<const uint8_t*>(mask);
#ifdef MMU_FWD_TC_DROPOUT
  if (keep != nullptr) {
    if (keep_words == nullptr) return (int)cudaErrorInvalidValue;
    return (int)launch_fwd<true>(q_t, k_t, v_t, row_stride, mask_t,
                                 static_cast<const uint8_t*>(keep), inv_keep,
                                 static_cast<uint32_t*>(keep_words), static_cast<bf16*>(out),
                                 static_cast<float*>(lse), B, S, H, st);
  }
#else
  if (keep != nullptr) return (int)cudaErrorInvalidValue;
#endif
  return (int)launch_fwd<false>(q_t, k_t, v_t, row_stride, mask_t, nullptr, 1.f, nullptr,
                                static_cast<bf16*>(out), static_cast<float*>(lse), B, S, H, st);
}
