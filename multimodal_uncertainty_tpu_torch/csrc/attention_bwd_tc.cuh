// Masked multi-head attention backward for Hopper (sm_90a) in bf16 on the
// tensor cores, without dropout and (DROPOUT) through the attention-probs
// dropout of BERT's training: the kernel templates and their C entry point.
// Each source defines MMU_BWD_TC_DH (and the shapes of its two passes, below;
// MMU_BWD_TC_DROPOUT where it holds the dropout instances too) before
// including this header, so the instances compile in separate nvcc
// processes, started together (ops/_build.py), one head dim a library:
//   * attention_bwd_tc.cu      Dh 64  (MMBT's and ViLT's 12 heads, BERT, K4;
//                                      with dropout: K5, MMBT's
//                                      --attention_probs_dropout);
//   * attention_bwd_tc_24.cu   Dh 24  (FLAVA fusion at 32 heads);
//   * attention_bwd_tc_48.cu   Dh 48  (FLAVA fusion at 16 heads);
//   * attention_bwd_tc_k6.cu   Dh 96  (FLAVA fusion at 8 heads);
//   * attention_bwd_tc_192.cu  Dh 192 (FLAVA fusion at 4 heads);
//   * attention_bwd_tc_256.cu  Dh 256 (FLAVA fusion's default 3 heads).
// Dh 384 and 768 run on clusters (attention_bwd_tc_wide.cuh); bf16 at Dh 32
// and 128, every fp32 head dim and the other dropout instances (bf16 at Dh
// 32, fp32) stay on attention_bwd_wide.cuh (ops/attention.py::bwd_source).
//
// Replaces these Pallas TPU kernels of multimodal_uncertainty_tpu/ops/attention.py
// in bf16 (each source names its own):
//   * _sdpa_flash_bwd_stream_impl :1521 (bodies _attn_kernel_flash_dq_stream
//     :1374 and _attn_kernel_flash_dkv_stream :1421): the long-context
//     backward (K4, reached through attention_flash);
//   * _sdpa_packed_bwd_impl :813, _sdpa_flash_bwd_impl :1219 and
//     _sdpa_hl_bwd_impl :504 (K1, K3, K2 bwd);
//   * _sdpa_bwd_impl :253 (body _attn_bwd_kernel :198; K6), which the TPU
//     runs heads-first at Dh 24, 48, 96 and 192; here the heads-last rows are
//     read in place;
//   * _sdpa_pallas_hl_drop_bwd :717 (pallas_call :729, body
//     _attn_bwd_kernel_hl_drop :595; K5): the backward chained through
//     dropout on the attention probabilities (the DROPOUT instances).
//
// Function and contract: those of attention_bwd_wide.cuh, unchanged. Three
// launches: delta = rowsum(dO * O) per (row, head); a dQ pass over query
// tiles looping over key tiles; a dK/dV pass over key tiles looping over
// query tiles. Each block owns its output rows and columns (no atomics,
// deterministic). P = exp(s * scale + bias - lse) in fp32 from the forward's
// lse, scale = 1 / sqrt(Dh); masked keys take the finite -1e30 after the
// scaled product (so P = 0), keys past S in the ragged last tile weigh
// exactly 0, and a query row with lse <= -5e29 (all its keys masked) takes
// P = 1/S, the gradient of the forward's uniform average. P (for P^T dO) and
// dS = P (dP - delta) (for dS K and dS^T Q) are rounded to bf16 before their
// products, as _attn_kernel_flash_dkv_stream does; every product sums in
// fp32. q, k, v are read through base pointers with one row stride (the
// packed (B, S, 3D) projection in place), dq, dk, dv written with their own;
// out and dout dense (B, S, D); lse and delta (B, H, S) fp32; 64-bit
// offsets, any S with no padding.
// Dropout (DROPOUT; attention_bwd_wide.cuh's contract): the forward computed
// O = Pd V with Pd = P keep inv_keep, so dV = Pd^T dO (Pd rounded to bf16),
// dP = keep inv_keep (dO V^T), dS = P (dP - delta), dQ and dK as above, and
// delta = rowsum(dO * O) unchanged. The uint8 (B, H, S, S) keep mask is
// indexed [query][key]. A fourth launch packs it into bits twice, into the
// caller's scratch: by query rows (bit i of word w of query q: key 32 w + i)
// and by key columns (bit i of word w of key k: query 32 w + i), zero past
// S. A warp packs a 32 x 32 block from 32 coalesced 32-byte loads (one query
// row's keys each), a ballot a load for the row words, each lane gathering
// its key's column word. The dQ pass then reads its own rows' words, the
// dK/dV pass its own keys' column words: 2 words a row of a thread (4 a
// 64-column tile) where the bytes took 32 loads, one a (row, column) element,
// and in the dK/dV pass transposed, 4 rows of the mask a warp's load
// (pack_keep in attention_tc.cuh, shared with the dropout forward). Each
// thread turns its words into a bit mask of its accumulator elements (rows g
// and g + 8 of its warp, columns 2 t4 and 2 t4 + 1 of each 8-column block),
// loaded before it waits for the tile. A fully masked row (P = 1/S) and keys
// or queries past S follow the same rule; an absent row's words are never
// read. The mask (10.45 MB at B=32, S=165, 12 heads) is read once.
//
// What bounds it: 10 B S^2 D flops of useful work (JAX's CostEstimate) at the
// bf16 tensor rate, or the bytes (8 B S D itemsize + the fp32 lse) at short
// S: at FLAVA's B=128, S=320, D=768 the flops take 0.10 ms at 989 TFLOP/s
// and the bytes 0.15 ms at 3.35 TB/s; K4's B=1, S=16384, 12 x 64 takes 2.08
// ms of flops. Like the micro-tile kernel this design recomputes S = q k^T
// and dP = dO v^T in both passes (14 B S^2 D flops executed) to keep each
// block's outputs in registers with no atomics. At the narrow head dims the
// exponentials bound it instead: P is rebuilt in both passes, 2 B H S^2
// exponentials whatever Dh, 0.23 ms at Dh 24 (32 heads), B=128, S=320 at the
// SFU's 16 a clock per SM; there two blocks an SM (MINB) let one block's
// softmax run beside the other's products.
//
// Design (FA2's backward on Hopper's warpgroup products, bf16 in, fp32 sums):
//   * pass 1 (delta) reads out and dout once, coalesced: 16-byte chunks to
//     consecutive threads, DH / 8 threads a (row, head), their partial sums
//     met in shared memory;
//   * a dQ or dK/dV block is two warpgroups. Where a warpgroup's outputs fit
//     its registers (64 rows x Dh of dQ, or of dK and dV: Dh 24-96, and dQ at
//     192 and 256) the two own 64 rows each, 128 a block (SPLIT 1). The
//     dK/dV pass at Dh 256 (SPLIT 2) gives the two the same 64 keys and 128
//     columns each of dK and dV (64 x 256 of both would be 256 fp32 registers
//     a thread); at Dh 192 (SPLIT 3, roles) the same 64 keys, warpgroup 0 all
//     of dV and warpgroup 1 all of dK (96 registers each; halves of 192 would
//     start warpgroup 1's columns mid-way through a 128-byte row, which an
//     MN-major descriptor cannot). Either way each computes S^T and dP^T for
//     half of the streamed queries and writes its P and dS, rounded to bf16,
//     into two 64 x 64 shared tiles (the exchange, FA3's hand-over), from
//     where the output products read them as their A operand. Without it
//     each would compute the full S^T and dP^T;
//   * the own rows' two operands (q and dO, or k and v) are loaded once and
//     stay for the whole loop: as the register A fragments of wgmma (AREG,
//     4 ceil(Dh / 16) registers each; at Dh 24 the fragments past column 24
//     are zero) where they fit, else as shared-memory tiles that wgmma reads
//     as A through a descriptor (at Dh 256 they would take 128 registers);
//   * the streamed operands (k and v, or q and dO) come in BT-row tiles
//     through a two-stage cp.async ring, rows past S zero-filled by the copy.
//     Every tile, own or streamed, is stored in 64-column panels (Dh 96 pads
//     its second panel to 64 columns, Dh 24 and 48 their one; nothing reads
//     past Dh rounded up to 16, and Dh 24's columns 24..31 are zero-filled)
//     of 128-byte rows in the 128-byte swizzle (16-byte chunk c of row r at
//     c ^ (r % 8)), which wgmma reads through a shared-memory descriptor: an
//     atom of 8 rows of 128 bytes, the next 8 rows 1 KB on. The same tile
//     serves as a K-major operand (S = q k^T: n = tile row, k = Dh; a k16
//     step moves the descriptor 32 bytes, a panel's 4 steps done, to the next
//     panel) and as
//     an MN-major one (dQ = dS k: k = tile row, n = Dh; a k16 step moves it 16
//     rows, 2 KB, and the leading-byte offset steps n from one panel to the
//     next, so Dh 96 is one m64n96k16);
//   * S (or S^T = k q^T) and dP (or dP^T = v dO^T) go into fp32 accumulators;
//     P and dS are formed there and, rounded to bf16, fed straight back as
//     the register A fragments of dQ += dS k (or dV += P^T dO and dK += dS^T
//     q), one m64nNk16 a step with N the warpgroup's output columns: the
//     accumulator layout is the register-A layout, so outside the exchange S,
//     P and dS never touch shared memory. The per-element work is one FMA,
//     one exp2 and a few adds: masked and absent keys (and absent queries)
//     carry -inf in the exponent, fully masked rows add their 1/S.
// Each source's header gives its passes' shapes and the times of the designs
// they were raced against.
// Left for later: TMA and a deeper ring, overlapping one tile's products with
// the next tile's softmax (both warpgroups wait at every tile's barriers), a
// persistent grid that loads the next block's own rows during this one's
// loop, one pass with atomics for dQ, staging the dK/dV pass's transposed
// keep bytes through shared memory by coalesced loads.
#pragma once
#include "attention_tc.cuh"

namespace {

// The shape of one pass at head dim DH: how the two warpgroups split a block
// (SPLIT 1: 64 rows each; 2: the same 64 rows, half of dK's and dV's columns
// each; 3: the same 64 rows, dV on warpgroup 0 and dK on 1), BT rows a
// streamed tile, the own rows' operands in registers (AREG 1) or shared
// memory (0), MINB blocks an SM. SPLIT 2 and 3 are the dK/dV pass's
// exchange: each warpgroup computes the scores of half the streamed rows and
// the two hand their P and dS to each other through shared memory (64 x BT
// bf16 tiles), from where the output products read them as A.
// A source names its passes' shapes as MMU_BWD_TC_DQ ("BT, AREG, MINB"; the
// dQ pass has SPLIT 1) and MMU_BWD_TC_DKV ("SPLIT, BT, AREG, MINB").
template <int DH, int SPLIT, int BT, int AREG, int MINB>
struct TcPass {
  static_assert(DH == 24 || DH == 32 || DH == 48 || DH == 64 || DH == 96 || DH == 128 ||
                    DH == 192 || DH == 256,
                "a head dim with a wgmma width n = Dh and its scale_of");
  static_assert(BT == 32 || BT == 64, "streamed tiles of 32 or 64 rows");
  static_assert(SPLIT == 1 || (SPLIT == 2 && DH % 128 == 0 && BT == 64 && AREG == 0) ||
                    (SPLIT == 3 && BT == 64 && AREG == 0),
                "the exchange: column halves of whole panels (SPLIT 2) or roles (3), "
                "128-byte rows of P and dS, the own operands in shared memory");
  static constexpr int kPanels = (DH + 63) / 64;   // 64-column panels a row
  static constexpr int kSteps = (DH + 15) / 16;    // k16 steps over Dh
  static constexpr int NC = SPLIT == 2 ? DH / 2 : DH;  // output columns a warpgroup owns
  static constexpr int kRows = SPLIT == 1 ? 128 : 64;  // rows a block owns
  static constexpr int kSN = SPLIT == 1 ? BT : BT / 2;  // streamed rows of a warpgroup's scores
  static constexpr int kTileBytes = kPanels * BT * 128;
  static constexpr int kOwnBytes = AREG != 0 ? 0 : kPanels * kRows * 128;  // each own operand
  static constexpr int kXchgOff = 2 * kOwnBytes + 4 * kTileBytes;     // after [stage][op] tiles
  static constexpr int kXchgBytes = 64 * BT * 2;                      // P (or dS) of 64 rows
  static constexpr int kInfoOff = kXchgOff + (SPLIT != 1 ? 2 * kXchgBytes : 0);
  static constexpr int kSmem = 1024 + kInfoOff + 2 * BT * 16;         // + alignment slack
  static_assert(kSmem <= 232448 && MINB * (kSmem + 1024) <= 233472,
                "shared memory of MINB blocks an SM");
};

// Pass 0 (DROPOUT): the keep mask's row and column words (pack_keep).
__global__ void __launch_bounds__(256)
attention_bwd_tc_keep_kernel(const uint8_t* __restrict__ keep, uint32_t* __restrict__ rows,
                             uint32_t* __restrict__ cols, int S, int W) {
  pack_keep<true>(keep, rows, cols, S, W);
}

// The block's shared memory: [q, dO] or [k, v] own tiles (none with AREG),
// the ring's [stage][two operands] tiles, the exchange's P and dS tiles (with
// SPLIT 2 or 3), then the ring's row info, from a 1024-byte aligned base.
struct TcSmem {
  uint32_t own, ring, xchg;
  uint8_t* xchg_ptr;
  void* info;
};
template <class P>
__device__ __forceinline__ TcSmem tc_smem(uint8_t* raw) {
  const uint32_t at = smem_u32(raw);
  const uint32_t base = (at + 1023) & ~1023u;
  return {base, base + 2 * P::kOwnBytes, base + P::kXchgOff, raw + (base - at) + P::kXchgOff,
          raw + (base - at) + P::kInfoOff};
}

// Pass 2: dQ for the 128 query rows of one (batch, head), 64 a warpgroup,
// looping over key tiles.
template <bool DROPOUT, int DH, int BT, int AREG, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
attention_bwd_tc_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, long long row_stride,
                           const uint8_t* __restrict__ mask,
                           const uint32_t* __restrict__ keep_rows, float inv_keep,
                           const bf16* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ delta, bf16* __restrict__ dq,
                           long long grad_stride, int S, int H) {
  using P = TcPass<DH, 1, BT, AREG, MINB>;
  constexpr float kScale = scale_of<DH>();
  extern __shared__ uint8_t smem_raw[];
  const TcSmem sm = tc_smem<P>(smem_raw);  // own [q, dO], ring [stage][k, v]
  // [stage][key]: exponent bias, 1/S if it exists (else 0)
  float2* kinfo = static_cast<float2*>(sm.info);

  const int q0 = blockIdx.x * P::kRows, h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = 64 * wg;  // the warpgroup's rows in the block
  const int D = H * DH;
  const long long head_off = (long long)b * S * row_stride + (long long)h * DH;
  const long long dout_off = (long long)b * S * D + (long long)h * DH;
  const long long stat_off = ((long long)b * H + h) * S;
  const uint8_t* key_mask = mask ? mask + (long long)b * S : nullptr;
  const float inv_s = 1.f / (float)S;

  auto prefetch = [&](int stage, int k0) {
    const uint32_t kt = sm.ring + 2 * stage * P::kTileBytes;
    load_rows<DH, BT>(kt, k + head_off, row_stride, k0, S);
    load_rows<DH, BT>(kt + P::kTileBytes, v + head_off, row_stride, k0, S);
    if (threadIdx.x < BT) {
      const int key = k0 + threadIdx.x;
      kinfo[stage * BT + threadIdx.x] =
          make_float2(key_bias(key_mask, key, S), key < S ? inv_s : 0.f);
    }
    cp_async_commit();
  };
  if constexpr (AREG == 0) {  // in the first group, with the first tile
    load_rows<DH, P::kRows>(sm.own, q + head_off, row_stride, q0, S);
    load_rows<DH, P::kRows>(sm.own + P::kOwnBytes, dout + dout_off, D, q0, S);
  }
  prefetch(0, 0);

  const int lo = q0 + row0 + warp * 16 + g, hi = lo + 8;
  uint32_t qa[AREG != 0 ? P::kSteps : 1][4], ga[AREG != 0 ? P::kSteps : 1][4];
  if constexpr (AREG != 0) {
    load_a_n<DH>(qa, q + head_off, row_stride, lo, hi, S, t4);
    load_a_n<DH>(ga, dout + dout_off, D, lo, hi, S, t4);
  }
  const uint32_t qs_own = sm.own + row0 * 128, gs_own = qs_own + P::kOwnBytes;
  float nlse[2], delta_r[2];
  bool uniform[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? hi : lo;
    const float l = row < S ? lse[stat_off + row] : 0.f;
    nlse[r] = neg_lse2(l, row < S);
    uniform[r] = row < S && l <= 0.5f * kMaskBias;
    delta_r[r] = row < S ? delta[stat_off + row] : 0.f;
  }

  const int W = (S + 31) / 32;  // keep words a row
  const uint32_t* keep_plane = DROPOUT ? keep_rows + stat_off * W : nullptr;

  float acc[P::NC / 8][4];
  zero_n(acc);
  const int n_tiles = (S + BT - 1) / BT;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) prefetch(stage ^ 1, (it + 1) * BT);
    // (own query, key) keep bits of this tile, loaded before the wait
    const uint32_t kept = DROPOUT ? keep_bits<BT / 8>(keep_plane, lo, hi, it * BT, S, W, t4) : 0u;
    if (it + 1 < n_tiles) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    const uint32_t ks = sm.ring + 2 * stage * P::kTileBytes, vs = ks + P::kTileBytes;

    float sc[BT / 8][4], dp[BT / 8][4];
    zero_n(sc);
    zero_n(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P::kSteps; ++kk) {  // S = q k^T
      if constexpr (AREG != 0) wgmma<0>(sc, qa[kk], desc_k<BT>(ks, kk));
      else wgmma_ss<0>(sc, desc_k<P::kRows>(qs_own, kk), desc_k<BT>(ks, kk));
    }
#pragma unroll
    for (int kk = 0; kk < P::kSteps; ++kk) {  // dP = dO v^T
      if constexpr (AREG != 0) wgmma<0>(dp, ga[kk], desc_k<BT>(vs, kk));
      else wgmma_ss<0>(dp, desc_k<P::kRows>(gs_own, kk), desc_k<BT>(vs, kk));
    }
    wgmma_commit();
    fence_n(sc);
    fence_n(dp);
    wgmma_wait();
    fence_n(sc);
    fence_n(dp);

    // dS = P (dP - delta) in place of dP (DROPOUT: dP takes keep inv_keep)
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float2 key = kinfo[stage * BT + 8 * j + 2 * t4 + (e & 1)];
        float p = ex2(fmaf(sc[j][e], kScale * kLog2e, nlse[r]) + key.x);
        if (uniform[r]) p = key.y;
        float dpv = dp[j][e];
        if constexpr (DROPOUT) dpv = (kept >> (4 * j + e)) & 1u ? dpv * inv_keep : 0.f;
        dp[j][e] = p * (dpv - delta_r[r]);
      }
    uint32_t dsa[BT / 16][4];
    to_a_n(dp, dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)  // dQ += dS k
      wgmma<1>(acc, dsa[kk], desc_mn<BT, P::kPanels>(ks, 0, kk));
    wgmma_commit();
    fence_n(acc);
    wgmma_wait();  // the tile is read: the next prefetch may overwrite it
    fence_n(acc);
    __syncthreads();
  }
  store_rows_n(acc, kScale, dq + (long long)b * S * grad_stride + (long long)h * DH, grad_stride,
               0, lo, hi, S, t4);
}

// Pass 3: dK and dV for the P::kRows keys of one (batch, head), looping over
// query tiles.
template <bool DROPOUT, int DH, int SPLIT, int BT, int AREG, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
attention_bwd_tc_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, long long row_stride,
                            const uint8_t* __restrict__ mask,
                            const uint32_t* __restrict__ keep_cols, float inv_keep,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, long long grad_stride,
                            int S, int H) {
  using P = TcPass<DH, SPLIT, BT, AREG, MINB>;
  constexpr float kScale = scale_of<DH>();
  extern __shared__ uint8_t smem_raw[];
  const TcSmem sm = tc_smem<P>(smem_raw);  // own [k, v], ring [stage][q, dO]
  // [stage][query]: -lse in the exp2 domain (-inf if fully masked or past S),
  // delta, 1/S if fully masked (else 0)
  float4* qinfo = static_cast<float4*>(sm.info);

  const int k0 = blockIdx.x * P::kRows, h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = SPLIT == 1 ? 64 * wg : 0;
  const int c0 = SPLIT == 2 ? P::NC * wg : 0;
  const int s0 = SPLIT == 1 ? 0 : P::kSN * wg;
  const int D = H * DH;
  const long long head_off = (long long)b * S * row_stride + (long long)h * DH;
  const long long dout_off = (long long)b * S * D + (long long)h * DH;
  const long long stat_off = ((long long)b * H + h) * S;
  const uint8_t* key_mask = mask ? mask + (long long)b * S : nullptr;
  const float inv_s = 1.f / (float)S;

  auto prefetch = [&](int stage, int q0) {
    const uint32_t qt = sm.ring + 2 * stage * P::kTileBytes;
    load_rows<DH, BT>(qt, q + head_off, row_stride, q0, S);
    load_rows<DH, BT>(qt + P::kTileBytes, dout + dout_off, D, q0, S);
    if (threadIdx.x < BT) {
      const int row = q0 + threadIdx.x;
      const float l = row < S ? lse[stat_off + row] : 0.f;
      const bool uniform = row < S && l <= 0.5f * kMaskBias;
      qinfo[stage * BT + threadIdx.x] = make_float4(
          neg_lse2(l, row < S), row < S ? delta[stat_off + row] : 0.f, uniform ? inv_s : 0.f, 0.f);
    }
    cp_async_commit();
  };
  if constexpr (AREG == 0) {  // in the first group, with the first tile
    load_rows<DH, P::kRows>(sm.own, k + head_off, row_stride, k0, S);
    load_rows<DH, P::kRows>(sm.own + P::kOwnBytes, v + head_off, row_stride, k0, S);
  }
  prefetch(0, 0);

  const int lo = k0 + row0 + warp * 16 + g, hi = lo + 8;
  uint32_t ka[AREG != 0 ? P::kSteps : 1][4], va[AREG != 0 ? P::kSteps : 1][4];
  if constexpr (AREG != 0) {
    load_a_n<DH>(ka, k + head_off, row_stride, lo, hi, S, t4);
    load_a_n<DH>(va, v + head_off, row_stride, lo, hi, S, t4);
  }
  const uint32_t ks_own = sm.own + row0 * 128, vs_own = ks_own + P::kOwnBytes;
  const float bias[2] = {key_bias(key_mask, lo, S), key_bias(key_mask, hi, S)};
  const bool exists[2] = {lo < S, hi < S};
  const int W = (S + 31) / 32;  // keep words a column
  const uint32_t* keep_plane = DROPOUT ? keep_cols + stat_off * W : nullptr;

  // with roles (SPLIT 3) dv_acc holds this warpgroup's output: dV on
  // warpgroup 0, dK on 1, and dk_acc is unused
  float dk_acc[SPLIT == 3 ? 1 : P::NC / 8][4], dv_acc[P::NC / 8][4];
  if constexpr (SPLIT != 3) zero_n(dk_acc);
  zero_n(dv_acc);
  const int n_tiles = (S + BT - 1) / BT;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) prefetch(stage ^ 1, (it + 1) * BT);
    // (streamed query, own key) keep bits of this tile, from the keys' column words
    const uint32_t kept =
        DROPOUT ? keep_bits<P::kSN / 8>(keep_plane, lo, hi, it * BT + s0, S, W, t4) : 0u;
    if (it + 1 < n_tiles) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    const uint32_t qs = sm.ring + 2 * stage * P::kTileBytes, gs = qs + P::kTileBytes;

    float sc[P::kSN / 8][4], dp[P::kSN / 8][4];
    zero_n(sc);
    zero_n(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P::kSteps; ++kk) {  // S^T = k q^T
      if constexpr (AREG != 0) wgmma<0>(sc, ka[kk], desc_k<BT>(qs + s0 * 128, kk));
      else wgmma_ss<0>(sc, desc_k<P::kRows>(ks_own, kk), desc_k<BT>(qs + s0 * 128, kk));
    }
#pragma unroll
    for (int kk = 0; kk < P::kSteps; ++kk) {  // dP^T = v dO^T
      if constexpr (AREG != 0) wgmma<0>(dp, va[kk], desc_k<BT>(gs + s0 * 128, kk));
      else wgmma_ss<0>(dp, desc_k<P::kRows>(vs_own, kk), desc_k<BT>(gs + s0 * 128, kk));
    }
    wgmma_commit();
    fence_n(sc);
    fence_n(dp);
    wgmma_wait();
    fence_n(sc);
    fence_n(dp);

    // P^T in place of S^T (DROPOUT: Pd^T = P^T keep inv_keep, the P of dV),
    // dS^T in place of dP^T (DROPOUT: dP^T takes keep inv_keep)
#pragma unroll
    for (int j = 0; j < P::kSN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float4 query = qinfo[stage * BT + s0 + 8 * j + 2 * t4 + (e & 1)];
        float p = ex2(fmaf(sc[j][e], kScale * kLog2e, query.x) + bias[r]);
        if (exists[r]) p += query.z;
        float dpv = dp[j][e];
        if constexpr (DROPOUT) {
          const bool on = (kept >> (4 * j + e)) & 1u;
          dpv = on ? dpv * inv_keep : 0.f;
          sc[j][e] = on ? p * inv_keep : 0.f;
        } else {
          sc[j][e] = p;
        }
        dp[j][e] = p * (dpv - query.y);
      }
    if constexpr (SPLIT != 1) {  // P^T and dS^T of all BT queries from both warpgroups
      store_xchg(sc, sm.xchg_ptr, s0, warp, g, t4);
      store_xchg(dp, sm.xchg_ptr + P::kXchgBytes, s0, warp, g, t4);
      fence_async_shared();
      __syncthreads();
      wgmma_fence();
      if constexpr (SPLIT == 3) {
        // warpgroup 0: dV += P^T dO; warpgroup 1: dK += dS^T q
        const uint32_t a_tile = sm.xchg + wg * P::kXchgBytes, b_tile = wg ? qs : gs;
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk)
          wgmma_ss<1>(dv_acc, desc_lbo(a_tile + 32 * kk, 16),
                      desc_mn<BT, P::kPanels>(b_tile, 0, kk));
      } else {
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk)  // dV += P^T dO
          wgmma_ss<1>(dv_acc, desc_lbo(sm.xchg + 32 * kk, 16),
                      desc_mn<BT, P::kPanels>(gs, c0, kk));
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk)  // dK += dS^T q
          wgmma_ss<1>(dk_acc, desc_lbo(sm.xchg + P::kXchgBytes + 32 * kk, 16),
                      desc_mn<BT, P::kPanels>(qs, c0, kk));
      }
    } else {
      uint32_t pa[BT / 16][4], dsa[BT / 16][4];
      to_a_n(sc, pa);
      to_a_n(dp, dsa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk)  // dV += P^T dO
        wgmma<1>(dv_acc, pa[kk], desc_mn<BT, P::kPanels>(gs, c0, kk));
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk)  // dK += dS^T q
        wgmma<1>(dk_acc, dsa[kk], desc_mn<BT, P::kPanels>(qs, c0, kk));
    }
    wgmma_commit();
    fence_n(dv_acc);
    if constexpr (SPLIT != 3) fence_n(dk_acc);
    wgmma_wait();  // the tiles are read: the next prefetch may overwrite them
    fence_n(dv_acc);
    if constexpr (SPLIT != 3) fence_n(dk_acc);
    __syncthreads();
  }
  const long long grad_off = (long long)b * S * grad_stride + (long long)h * DH;
  if constexpr (SPLIT == 3) {
    store_rows_n(dv_acc, wg ? kScale : 1.f, (wg ? dk : dv) + grad_off, grad_stride, 0, lo, hi, S,
                 t4);
  } else {
    store_rows_n(dk_acc, kScale, dk + grad_off, grad_stride, c0, lo, hi, S, t4);
    store_rows_n(dv_acc, 1.f, dv + grad_off, grad_stride, c0, lo, hi, S, t4);
  }
}

// Launch one pass's kernel with its dynamic shared memory.
template <class P, class Kernel, class... Args>
cudaError_t launch_pass(Kernel kernel, int S, int H, int B, cudaStream_t st, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((S + P::kRows - 1) / P::kRows, H, B), kThreads, P::kSmem, st>>>(args...);
  return cudaGetLastError();
}

// The dQ and dK/dV passes, with or without dropout.
// (DROPOUT: first the keep mask's bits, rows then columns, into keep_words).
template <bool DROPOUT>
cudaError_t launch_passes(const bf16* q, const bf16* k, const bf16* v, long long row_stride,
                          const uint8_t* mask, const uint8_t* keep, float inv_keep,
                          uint32_t* keep_words, const bf16* dout, const float* lse,
                          const float* delta, bf16* dq, bf16* dk, bf16* dv,
                          long long grad_stride, int B, int S, int H, cudaStream_t st) {
  constexpr int DH = MMU_BWD_TC_DH;
  using DQ = TcPass<DH, 1, MMU_BWD_TC_DQ>;
  using DKV = TcPass<DH, MMU_BWD_TC_DKV>;
  const int W = (S + 31) / 32;
  uint32_t* keep_rows = keep_words;
  uint32_t* keep_cols = DROPOUT ? keep_words + (long long)B * H * S * W : nullptr;
  if constexpr (DROPOUT) {
    attention_bwd_tc_keep_kernel<<<dim3(W, (W + 7) / 8, B * H), 256, 0, st>>>(keep, keep_rows,
                                                                             keep_cols, S, W);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = launch_pass<DQ>(attention_bwd_tc_dq_kernel<DROPOUT, DH, MMU_BWD_TC_DQ>, S, H,
                                    B, st, q, k, v, row_stride, mask,
                                    (const uint32_t*)keep_rows, inv_keep, dout, lse, delta, dq,
                                    grad_stride, S, H);
  if (err != cudaSuccess) return err;
  return launch_pass<DKV>(attention_bwd_tc_dkv_kernel<DROPOUT, DH, MMU_BWD_TC_DKV>, S, H, B, st,
                          q, k, v, row_stride, mask, (const uint32_t*)keep_cols, inv_keep, dout,
                          lse, delta, dk, dv, grad_stride, S, H);
}

}  // namespace

// Plain C entry point (loaded with ctypes); bf16 only, Dh = MMU_BWD_TC_DH.
// q, k, v: (B, S, H * Dh) views with row stride row_stride (a multiple of 8
// elements, 16-byte aligned bases); mask: (B, S) bytes, nonzero = key kept,
// or NULL; keep: the forward's (B, H, S, S) dropout bytes with its inv_keep
// (a source without MMU_BWD_TC_DROPOUT refuses one) and keep_words, (2, B,
// H, S, ceil(S / 32)) 32-bit scratch for its bits, or all three NULL / 1 for
// no dropout; out, dout: dense (B, S, H * Dh); lse: (B, H, S) float32 from
// the forward; delta: (B, H, S) float32 scratch; dq, dk, dv: views with row
// stride grad_stride (even). Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for what the library has no instance of).
extern "C" int mmu_attention_bwd_tc(const void* q, const void* k, const void* v,
                                    long long row_stride, const void* mask, const void* keep,
                                    float inv_keep, void* keep_words, const void* out,
                                    const void* dout, const void* lse, void* delta, void* dq,
                                    void* dk, void* dv, long long grad_stride, int B, int S,
                                    int H, int device, void* stream) {
  constexpr int DH = MMU_BWD_TC_DH;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || S < 1 || H < 1 || row_stride % 8 || grad_stride % 2)
    return (int)cudaErrorInvalidValue;
#ifndef MMU_BWD_TC_DROPOUT
  if (keep != nullptr) return (int)cudaErrorInvalidValue;
#endif
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* q_t = static_cast<const bf16*>(q);
  const bf16* k_t = static_cast<const bf16*>(k);
  const bf16* v_t = static_cast<const bf16*>(v);
  const bf16* dout_t = static_cast<const bf16*>(dout);
  const uint8_t* mask_t = static_cast<const uint8_t*>(mask);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);

  err = launch_delta<DH>(static_cast<const bf16*>(out), dout_t, delta_f, B, S, H, st);
  if (err != cudaSuccess) return (int)err;

#ifdef MMU_BWD_TC_DROPOUT
  if (keep != nullptr) {
    if (keep_words == nullptr) return (int)cudaErrorInvalidValue;
    return (int)launch_passes<true>(q_t, k_t, v_t, row_stride, mask_t,
                                    static_cast<const uint8_t*>(keep), inv_keep,
                                    static_cast<uint32_t*>(keep_words), dout_t, lse_f, delta_f,
                                    static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                                    static_cast<bf16*>(dv), grad_stride, B, S, H, st);
  }
#endif
  return (int)launch_passes<false>(q_t, k_t, v_t, row_stride, mask_t, nullptr, 1.f, nullptr,
                                   dout_t, lse_f, delta_f, static_cast<bf16*>(dq),
                                   static_cast<bf16*>(dk), static_cast<bf16*>(dv), grad_stride, B,
                                   S, H, st);
}
