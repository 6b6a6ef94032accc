// Masked multi-head attention backward for Hopper (sm_90a) in bf16 at the
// widest head dims, Dh 384 and 768, without dropout, on the tensor cores and
// thread-block clusters: the kernel templates and their C entry point. Each
// source defines MMU_BWD_TC_DH before including this header, so the two
// compile in separate nvcc processes, started together (ops/_build.py):
//   * attention_bwd_tc_384.cu  Dh 384 (FLAVA fusion at 2 heads of D=768);
//   * attention_bwd_tc_768.cu  Dh 768 (FLAVA fusion at 1 head).
// fp32 at these head dims stays on the FMA cluster kernel of
// attention_bwd_wide.cuh (ops/attention.py::bwd_source).
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_bwd_impl
// :813 (K1, pallas_call :828, body _attn_bwd_kernel_hl :443) and
// _sdpa_flash_bwd_impl :1219 (K3, pallas_calls :1234 and :1256, bodies
// _attn_kernel_flash_dq :1105 and _attn_kernel_flash_dkv :1151) in bf16 at 2
// and 1 heads of 768: the JAX package keeps S = 320 on the whole-sequence
// kernel and takes the flash kernel at S = 736.
//
// Function and contract: those of attention_bwd_tc.cuh, unchanged. Three
// launches: delta = rowsum(dO * O) per (row, head); a dQ pass over query
// blocks looping over key tiles; a dK/dV pass over key blocks looping over
// query tiles. P = exp(s * scale + bias - lse) in fp32 from the forward's lse
// with scale = scale_of<DH>(), 1 / sqrt(Dh) of the whole head whatever slice
// a block holds; masked keys take the finite -1e30 after the scaled product,
// keys past S weigh exactly 0, a query row with lse <= -5e29 takes P = 1/S. P
// and dS = P (dP - delta) are rounded to bf16 before their products, and
// every product sums in fp32. q, k, v are read in place through one row
// stride (the packed (B, S, 3D) projection), dq, dk, dv written with their
// own; out and dout dense (B, S, D); lse and delta (B, H, S) fp32; 64-bit
// offsets, any S with no padding. Each block owns its outputs: no atomics,
// the result is deterministic.
//
// What bounds it: 10 B S^2 D flops of useful work (JAX's CostEstimate) on the
// bf16 tensor cores, or the bytes (8 B S D x 2 + the fp32 lse): at FLAVA's
// B=128, S=320, D=768 the flops take 0.10 ms at 989 TFLOP/s and the bytes
// 0.15 ms at 3.35 TB/s. Like attention_bwd_tc.cuh this design executes 14 B
// S^2 D (S and dP in both passes).
//
// Design. 64 rows x Dh of dQ, or of dK and dV, do not fit a warpgroup's
// registers (384 fp32 a thread at Dh 768), so the head is split as the
// forward splits it (attention_fwd_tc_wide.cuh): a cluster of N = Dh / C
// blocks (2 at Dh 384, 4 at 768) owns 64 rows (queries in the dQ pass, keys
// in the dK/dV pass), each block one C = 192-column slice of them. Inside a
// block each pass has the shape attention_bwd_tc.cuh runs at Dh 192:
//   * the own rows' two slices (q and dO, or k and v; 24 KB each) stay in
//     shared memory, read by wgmma as A through a descriptor; the streamed
//     slices (k and v, or q and dO) come in 64-row tiles through a two-stage
//     cp.async ring (96 KB), rows past S zero-filled, all in 64-column panels
//     of 128-byte rows in the 128-byte swizzle;
//   * each warpgroup computes the slice's partial scores for half of a
//     streamed tile's rows: S and dP (m64n32, 12 k16 steps over the slice),
//     or S^T and dP^T in the dK/dV pass;
//   * dQ pass: each warpgroup accumulates dQ over its half of every key tile,
//     64 x 192 in one m64n192 accumulator (96 fp32 a thread); the two are
//     summed through shared memory at the end;
//   * dK/dV pass: the roles of attention_bwd_tc.cuh's SPLIT 3: warpgroup 0
//     holds all of the slice's dV, warpgroup 1 all of its dK (96 fp32 each);
//     P^T and dS^T, rounded to bf16, meet in two 64 x 64 exchange tiles, from
//     where the products read them as A.
// What is new is that S and dP are partial sums over the block's slice: they
// are summed across the cluster before P and dS are formed, in rank order 0
// .. N-1 in every block, so that every block forms the same P and dS bit for
// bit (fp32 addition does not associate). Two ways, by the cluster's size N:
//   all-read (N = 2; the forward's way): each block writes its partials to its
//     shared memory in its threads' accumulator order and, after one
//     barrier.cluster, every thread reads the N partials of its own elements
//     through distributed shared memory; two buffers by tile parity;
//   reduce-scatter, then all-gather (N = 4): after the barrier each block sums
//     1/N of the positions over the N blocks, forms their P and dS and
//     writes them, rounded to bf16, into every block's exchange tiles; a
//     second barrier, and the products go on locally.
// At N = 4 the all-read moves N x 32 KB of partials a tile a block through
// distributed shared memory and the reduce-scatter 32 KB plus 16 KB of P and
// dS; at N = 2 the two are close and the second barrier costs more than the
// bytes it saves. The sources' headers give the race's times. Shared memory
// at the all-read's dK/dV pass: the own slices 48 KB, the ring 96 KB, two
// buffers of both planes' partials 64 KB, the exchange 16 KB, the queries'
// info 2 KB: 227 KB with the alignment slack, the most a block may take.
// Left for later: TMA and a deeper ring, overlapping one warpgroup's softmax
// with the other's products, multicasting the streamed tiles to the blocks
// of a cluster that need the same rows.
#pragma once
#include "attention_tc.cuh"
#include "cluster.cuh"

namespace {

// A pass's layout at head dim DH (DQ: the dQ pass, else the dK/dV pass):
// output slices of C = 192 columns, N = DH / C blocks a cluster, 64 own rows,
// 64-row streamed tiles, half a tile's rows a warpgroup's scores.
template <int DH, bool DQ>
struct BwdTcWide {
  static_assert(DH == 384 || DH == 768, "the head dims of FLAVA fusion at 2 and 1 heads");
  static constexpr int C = 192;                  // output columns a block owns
  static constexpr int N = DH / C;               // blocks a cluster
  static constexpr int SUM = N == 2 ? 0 : 1;     // all-read (0) or reduce-scatter (1)
  static constexpr int kRows = 64;               // own rows a cluster owns
  static constexpr int BT = 64;                  // rows a streamed tile
  static constexpr int kSN = BT / 2;             // streamed rows of a warpgroup's scores
  static constexpr int J = kSN / 8;              // 8-column blocks of a warpgroup's scores
  static constexpr int kPanels = C / 64;         // 64-column panels of a slice row
  static constexpr int kSteps = C / 16;          // k16 steps of the partial scores
  static constexpr int kOwnBytes = kPanels * kRows * 128;   // each own operand's slice
  static constexpr int kTileBytes = kPanels * BT * 128;     // each streamed operand's slice
  static constexpr int kRingOff = 2 * kOwnBytes;
  static constexpr int kPlaneBytes = kRows * BT * 4;        // a tile's partial S (or dP)
  static constexpr int kBufs = SUM == 0 ? 2 : 1;            // by tile parity (SUM 0)
  static constexpr int kPartOff = kRingOff + 4 * kTileBytes;
  static constexpr int kXchgOff = kPartOff + kBufs * 2 * kPlaneBytes;
  static constexpr int kXchgBytes = kRows * BT * 2;         // a tile's P (or dS) in bf16
  // P^T and dS^T in the dK/dV pass; dS in the dQ pass when another block forms it
  static constexpr int kXchgs = DQ ? (SUM == 0 ? 0 : 1) : 2;
  static constexpr int kInfoOff = kXchgOff + kXchgs * kXchgBytes;
  static constexpr int kInfoBytes = 2 * BT * (DQ ? 8 : 16);  // [stage][streamed row]
  static constexpr int kRowInfoOff = kInfoOff + kInfoBytes;   // the own rows' (SUM 1)
  static constexpr int kSmem = 1024 + kRowInfoOff + (SUM == 0 ? 0 : kRows * 16);
  static_assert(N * C == DH && kSmem <= 232448, "one block's shared memory");
  static_assert(kPartOff % 1024 == 0 && kXchgOff % 1024 == 0, "swizzle atoms 1 KB aligned");
};

// This thread's partials of a tile, S (plane 0) and dP (1), into buffer buf:
// float4 j of thread t of plane p at ((buf * 2 + p) * J + j) kThreads + t.
template <int J>
__device__ __forceinline__ void publish(float4* part, int buf, const float (&sc)[J][4],
                                        const float (&dp)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    part[((buf * 2) * J + j) * kThreads + threadIdx.x] =
        make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
    part[((buf * 2 + 1) * J + j) * kThreads + threadIdx.x] =
        make_float4(dp[j][0], dp[j][1], dp[j][2], dp[j][3]);
  }
}

// (SUM 0) The sums of this thread's elements over the cluster's N blocks'
// partials in buffer buf, in rank order.
template <int N, int J>
__device__ __forceinline__ void sum_all(uint32_t part, int buf, float (&sc)[J][4],
                                        float (&dp)[J][4]) {
  zero_n(sc);
  zero_n(dp);
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float4 x = ld_cluster4(part + 16 * (((buf * 2) * J + j) * kThreads + threadIdx.x), r);
      const float4 y =
          ld_cluster4(part + 16 * (((buf * 2 + 1) * J + j) * kThreads + threadIdx.x), r);
      sc[j][0] += x.x;
      sc[j][1] += x.y;
      sc[j][2] += x.z;
      sc[j][3] += x.w;
      dp[j][0] += y.x;
      dp[j][1] += y.y;
      dp[j][2] += y.z;
      dp[j][3] += y.w;
    }
}

// (SUM 1) This block's 1/N of a tile's positions: the float4 slots rank x
// J kThreads / N .. of the published partials (buffer 0), each summed over
// the N blocks in rank order; form(row, col, s, dp, p, ds) turns a position's
// sums into its P and dS (row: the own row, col: the streamed row, both local
// to the tile), which go, rounded to bf16 in pairs, into the exchange tiles
// xchg_p (unless WITH_P is false) and xchg_ds of every block of the cluster,
// where the owner thread's store_xchg would have put them.
template <int N, int J, bool WITH_P, class Form>
__device__ __forceinline__ void sum_scatter(uint32_t part, uint32_t xchg_p, uint32_t xchg_ds,
                                            Form form) {
  constexpr int kSlots = J * kThreads / N;
  constexpr int kPlane = J * kThreads * 16;
  const int rank = (int)cluster_rank();
#pragma unroll
  for (int i = threadIdx.x; i < kSlots; i += kThreads) {
    const int slot = rank * kSlots + i;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const float4 a = ld_cluster4(part + 16 * slot, r);
      const float4 c = ld_cluster4(part + kPlane + 16 * slot, r);
      x = make_float4(x.x + a.x, x.y + a.y, x.z + a.z, x.w + a.w);
      y = make_float4(y.x + c.x, y.y + c.y, y.z + c.z, y.w + c.w);
    }
    // the owner thread t of float4 j: warpgroup t / 128 holds streamed rows 32 wg ..
    const int j = slot / kThreads, t = slot % kThreads;
    const int lane = t % 32, g = lane / 4, t4 = lane % 4;
    const int lo = t / 32 % 4 * 16 + g, hi = lo + 8, col = 32 * (t / 128) + 8 * j + 2 * t4;
    float p[4], ds[4];
    form(lo, col, x.x, y.x, p[0], ds[0]);
    form(lo, col + 1, x.y, y.y, p[1], ds[1]);
    form(hi, col, x.z, y.z, p[2], ds[2]);
    form(hi, col + 1, x.w, y.w, p[3], ds[3]);
    const int c = col / 8;
    const uint32_t at_lo = lo * 128 + ((c ^ (lo & 7)) << 4) + 4 * t4;
    const uint32_t at_hi = hi * 128 + ((c ^ (hi & 7)) << 4) + 4 * t4;
    const uint32_t p_lo = pack(p[0], p[1]), p_hi = pack(p[2], p[3]);
    const uint32_t ds_lo = pack(ds[0], ds[1]), ds_hi = pack(ds[2], ds[3]);
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if constexpr (WITH_P) {
        st_cluster_u32(xchg_p + at_lo, r, p_lo);
        st_cluster_u32(xchg_p + at_hi, r, p_hi);
      }
      st_cluster_u32(xchg_ds + at_lo, r, ds_lo);
      st_cluster_u32(xchg_ds + at_hi, r, ds_hi);
    }
  }
}

// The dQ pass: the 64 query rows of one (batch, head) and the C columns of dQ
// of the block's rank in its cluster, looping over key tiles.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_tc_wide_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, long long row_stride,
                                const uint8_t* __restrict__ mask, const bf16* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                bf16* __restrict__ dq, long long grad_stride, int S, int H) {
  using P = BwdTcWide<DH, true>;
  constexpr int C = P::C, N = P::N, BT = P::BT, J = P::J;
  constexpr float kScale = scale_of<DH>();  // the whole head's 1 / sqrt(Dh)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t at = smem_u32(smem_raw);
  // [q, dO] own slices, the ring's [stage][k, v] tiles, the partials, the dS exchange (SUM 1),
  // [stage][key] info, the own rows' info (SUM 1)
  const uint32_t own = (at + 1023) & ~1023u;
  const uint32_t ring = own + P::kRingOff, part = own + P::kPartOff, xchg = own + P::kXchgOff;
  uint8_t* base = smem_raw + (own - at);
  float4* part_ptr = reinterpret_cast<float4*>(base + P::kPartOff);
  float2* kinfo = reinterpret_cast<float2*>(base + P::kInfoOff);  // bias, 1/S if it exists
  float4* rinfo = reinterpret_cast<float4*>(base + P::kRowInfoOff);

  const int rank = (int)cluster_rank();
  const int q0 = (int)cluster_id() * P::kRows, h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int s0 = P::kSN * wg;  // the warpgroup's keys in a tile
  const int D = H * DH;
  const int c0 = rank * C;     // the block's slice of the head's columns
  const long long head_off = (long long)b * S * row_stride + (long long)h * DH + c0;
  const long long dout_off = (long long)b * S * D + (long long)h * DH + c0;
  const long long stat_off = ((long long)b * H + h) * S;
  const uint8_t* key_mask = mask ? mask + (long long)b * S : nullptr;
  const float inv_s = 1.f / (float)S;

  auto prefetch = [&](int stage, int k0) {
    const uint32_t kt = ring + 2 * stage * P::kTileBytes;
    load_rows<C, BT>(kt, k + head_off, row_stride, k0, S);
    load_rows<C, BT>(kt + P::kTileBytes, v + head_off, row_stride, k0, S);
    if (threadIdx.x < BT) {
      const int key = k0 + threadIdx.x;
      kinfo[stage * BT + threadIdx.x] =
          make_float2(key_bias(key_mask, key, S), key < S ? inv_s : 0.f);
    }
    cp_async_commit();
  };
  load_rows<C, P::kRows>(own, q + head_off, row_stride, q0, S);  // in the first group
  load_rows<C, P::kRows>(own + P::kOwnBytes, dout + dout_off, D, q0, S);
  prefetch(0, 0);

  const int lo = q0 + warp * 16 + g, hi = lo + 8;  // both warpgroups own all 64 rows
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
  if constexpr (P::SUM != 0) {
    if (threadIdx.x < P::kRows) {  // the own rows' info for the positions this block sums
      const int row = q0 + threadIdx.x;
      const float l = row < S ? lse[stat_off + row] : 0.f;
      rinfo[threadIdx.x] = make_float4(neg_lse2(l, row < S), row < S ? delta[stat_off + row] : 0.f,
                                       row < S && l <= 0.5f * kMaskBias ? 1.f : 0.f, 0.f);
    }
  }

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

    // this slice's part of S = q k^T and dP = dO v^T for the warpgroup's keys
    float sc[J][4], dp[J][4];
    zero_n(sc);
    zero_n(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P::kSteps; ++kk)
      wgmma_ss<0>(sc, desc_k<P::kRows>(own, kk), desc_k<BT>(ks + s0 * 128, kk));
#pragma unroll
    for (int kk = 0; kk < P::kSteps; ++kk)
      wgmma_ss<0>(dp, desc_k<P::kRows>(own + P::kOwnBytes, kk), desc_k<BT>(vs + s0 * 128, kk));
    wgmma_commit();
    fence_n(sc);
    fence_n(dp);
    wgmma_wait();
    fence_n(sc);
    fence_n(dp);

    const int buf = P::SUM == 0 ? it & 1 : 0;
    publish(part_ptr, buf, sc, dp);
    cluster_sync();  // every block's partials of this tile are in
    if constexpr (P::SUM == 0) {
      sum_all<N>(part, buf, sc, dp);
      // dS = P (dP - delta) in place of dP
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float2 key = kinfo[stage * BT + s0 + 8 * j + 2 * t4 + (e & 1)];
          float p = ex2(fmaf(sc[j][e], kScale * kLog2e, nlse[r]) + key.x);
          if (uniform[r]) p = key.y;
          dp[j][e] = p * (dp[j][e] - delta_r[r]);
        }
      uint32_t dsa[J / 2][4];
      to_a_n(dp, dsa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < J / 2; ++kk)  // dQ += dS k over the warpgroup's keys
        wgmma<1>(acc, dsa[kk], desc_mn<BT, P::kPanels>(ks, 0, s0 / 16 + kk));
    } else {
      sum_scatter<N, J, false>(part, 0, xchg, [&](int row, int col, float s, float d, float& p,
                                                  float& ds) {
        const float4 ri = rinfo[row];
        const float2 key = kinfo[stage * BT + col];
        p = ex2(fmaf(s, kScale * kLog2e, ri.x) + key.x);
        if (ri.z != 0.f) p = key.y;
        ds = p * (d - ri.y);
      });
      cluster_sync();  // every block's dS of this tile is in every block
      fence_async_shared();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < J / 2; ++kk)  // dQ += dS k over the warpgroup's keys
        wgmma_ss<1>(acc, desc_lbo(xchg + 2 * s0 + 32 * kk, 16),
                    desc_mn<BT, P::kPanels>(ks, 0, s0 / 16 + kk));
    }
    wgmma_commit();
    fence_n(acc);
    wgmma_wait();  // the tiles are read: the next prefetch may overwrite them
    fence_n(acc);
    __syncthreads();
  }
  if constexpr (P::SUM == 0) cluster_sync();  // no block reads another's partials past this

  // dQ = the two warpgroups' sums, through the ring's first bytes
  float4* red = reinterpret_cast<float4*>(base + P::kRingOff);
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
      red[j * 128 + threadIdx.x - 128] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const float4 x = red[j * 128 + threadIdx.x];
      acc[j][0] += x.x;
      acc[j][1] += x.y;
      acc[j][2] += x.z;
      acc[j][3] += x.w;
    }
    store_rows_n(acc, kScale, dq + (long long)b * S * grad_stride + (long long)h * DH, grad_stride,
                 c0, lo, hi, S, t4);
  }
}

// The dK/dV pass: the 64 keys of one (batch, head) and the C columns of dK
// and dV of the block's rank in its cluster, looping over query tiles.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_tc_wide_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, long long row_stride,
                                 const uint8_t* __restrict__ mask, const bf16* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 bf16* __restrict__ dk, bf16* __restrict__ dv,
                                 long long grad_stride, int S, int H) {
  using P = BwdTcWide<DH, false>;
  constexpr int C = P::C, N = P::N, BT = P::BT, J = P::J;
  constexpr float kScale = scale_of<DH>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t at = smem_u32(smem_raw);
  // [k, v] own slices, the ring's [stage][q, dO] tiles, the partials, the P^T and dS^T
  // exchange, [stage][query] info, the own rows' info (SUM 1)
  const uint32_t own = (at + 1023) & ~1023u;
  const uint32_t ring = own + P::kRingOff, part = own + P::kPartOff, xchg = own + P::kXchgOff;
  uint8_t* base = smem_raw + (own - at);
  float4* part_ptr = reinterpret_cast<float4*>(base + P::kPartOff);
  // -lse in the exp2 domain (-inf if fully masked or past S), delta, 1/S if fully masked
  float4* qinfo = reinterpret_cast<float4*>(base + P::kInfoOff);
  float4* rinfo = reinterpret_cast<float4*>(base + P::kRowInfoOff);

  const int rank = (int)cluster_rank();
  const int k0 = (int)cluster_id() * P::kRows, h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int s0 = P::kSN * wg;  // the warpgroup's queries in a tile
  const int D = H * DH;
  const int c0 = rank * C;
  const long long head_off = (long long)b * S * row_stride + (long long)h * DH + c0;
  const long long dout_off = (long long)b * S * D + (long long)h * DH + c0;
  const long long stat_off = ((long long)b * H + h) * S;
  const uint8_t* key_mask = mask ? mask + (long long)b * S : nullptr;
  const float inv_s = 1.f / (float)S;

  auto prefetch = [&](int stage, int q0) {
    const uint32_t qt = ring + 2 * stage * P::kTileBytes;
    load_rows<C, BT>(qt, q + head_off, row_stride, q0, S);
    load_rows<C, BT>(qt + P::kTileBytes, dout + dout_off, D, q0, S);
    if (threadIdx.x < BT) {
      const int row = q0 + threadIdx.x;
      const float l = row < S ? lse[stat_off + row] : 0.f;
      const bool uniform = row < S && l <= 0.5f * kMaskBias;
      qinfo[stage * BT + threadIdx.x] = make_float4(
          neg_lse2(l, row < S), row < S ? delta[stat_off + row] : 0.f, uniform ? inv_s : 0.f, 0.f);
    }
    cp_async_commit();
  };
  load_rows<C, P::kRows>(own, k + head_off, row_stride, k0, S);  // in the first group
  load_rows<C, P::kRows>(own + P::kOwnBytes, v + head_off, row_stride, k0, S);
  prefetch(0, 0);

  const int lo = k0 + warp * 16 + g, hi = lo + 8;  // both warpgroups own all 64 keys
  const float bias[2] = {key_bias(key_mask, lo, S), key_bias(key_mask, hi, S)};
  const bool exists[2] = {lo < S, hi < S};
  if constexpr (P::SUM != 0) {
    if (threadIdx.x < P::kRows) {
      const int key = k0 + threadIdx.x;
      rinfo[threadIdx.x] = make_float4(key_bias(key_mask, key, S), key < S ? 1.f : 0.f, 0.f, 0.f);
    }
  }

  // warpgroup 0: dV; warpgroup 1: dK
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
    const uint32_t qs = ring + 2 * stage * P::kTileBytes, gs = qs + P::kTileBytes;

    // this slice's part of S^T = k q^T and dP^T = v dO^T for the warpgroup's queries
    float sc[J][4], dp[J][4];
    zero_n(sc);
    zero_n(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P::kSteps; ++kk)
      wgmma_ss<0>(sc, desc_k<P::kRows>(own, kk), desc_k<BT>(qs + s0 * 128, kk));
#pragma unroll
    for (int kk = 0; kk < P::kSteps; ++kk)
      wgmma_ss<0>(dp, desc_k<P::kRows>(own + P::kOwnBytes, kk), desc_k<BT>(gs + s0 * 128, kk));
    wgmma_commit();
    fence_n(sc);
    fence_n(dp);
    wgmma_wait();
    fence_n(sc);
    fence_n(dp);

    const int buf = P::SUM == 0 ? it & 1 : 0;
    publish(part_ptr, buf, sc, dp);
    cluster_sync();  // every block's partials of this tile are in
    if constexpr (P::SUM == 0) {
      sum_all<N>(part, buf, sc, dp);
      // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float4 query = qinfo[stage * BT + s0 + 8 * j + 2 * t4 + (e & 1)];
          float p = ex2(fmaf(sc[j][e], kScale * kLog2e, query.x) + bias[r]);
          if (exists[r]) p += query.z;
          sc[j][e] = p;
          dp[j][e] = p * (dp[j][e] - query.y);
        }
      store_xchg(sc, base + P::kXchgOff, s0, warp, g, t4);
      store_xchg(dp, base + P::kXchgOff + P::kXchgBytes, s0, warp, g, t4);
      fence_async_shared();
      __syncthreads();
    } else {
      sum_scatter<N, J, true>(part, xchg, xchg + P::kXchgBytes, [&](int row, int col, float s,
                                                                    float d, float& p, float& ds) {
        const float4 ri = rinfo[row];
        const float4 query = qinfo[stage * BT + col];
        p = ex2(fmaf(s, kScale * kLog2e, query.x) + ri.x);
        if (ri.y != 0.f) p += query.z;
        ds = p * (d - query.y);
      });
      cluster_sync();  // every block's P^T and dS^T of this tile are in every block
      fence_async_shared();
    }
    // warpgroup 0: dV += P^T dO; warpgroup 1: dK += dS^T q
    const uint32_t a_tile = xchg + wg * P::kXchgBytes, b_tile = wg ? qs : gs;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      wgmma_ss<1>(acc, desc_lbo(a_tile + 32 * kk, 16), desc_mn<BT, P::kPanels>(b_tile, 0, kk));
    wgmma_commit();
    fence_n(acc);
    wgmma_wait();  // the tiles are read: the next prefetch may overwrite them
    fence_n(acc);
    __syncthreads();
  }
  if constexpr (P::SUM == 0) cluster_sync();  // no block reads another's partials past this
  store_rows_n(acc, wg ? kScale : 1.f,
               (wg ? dk : dv) + (long long)b * S * grad_stride + (long long)h * DH, grad_stride,
               c0, lo, hi, S, t4);
}

}  // namespace

// Plain C entry point (loaded with ctypes), the signature of
// attention_bwd_tc.cuh's; bf16 only, Dh = MMU_BWD_TC_DH, no dropout (a keep
// mask is refused). q, k, v: (B, S, H * Dh) views with row stride row_stride
// (a multiple of 8 elements, 16-byte aligned bases); mask: (B, S) bytes,
// nonzero = key kept, or NULL; out, dout: dense (B, S, H * Dh); lse: (B, H,
// S) float32 from the forward; delta: (B, H, S) float32 scratch; dq, dk, dv:
// views with row stride grad_stride (even). Returns the cudaError_t of the
// launches.
extern "C" int mmu_attention_bwd_tc(const void* q, const void* k, const void* v,
                                    long long row_stride, const void* mask, const void* keep,
                                    float, void*, const void* out, const void* dout,
                                    const void* lse, void* delta, void* dq, void* dk, void* dv,
                                    long long grad_stride, int B, int S, int H, int device,
                                    void* stream) {
  constexpr int DH = MMU_BWD_TC_DH;
  using DQ = BwdTcWide<DH, true>;
  using DKV = BwdTcWide<DH, false>;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || S < 1 || H < 1 || row_stride % 8 || grad_stride % 2 || keep != nullptr)
    return (int)cudaErrorInvalidValue;
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
  const dim3 grid((S + DQ::kRows - 1) / DQ::kRows * DQ::N, H, B);
  err = launch_clusters<DQ::N>(attention_bwd_tc_wide_dq_kernel<DH>, grid, kThreads, DQ::kSmem,
                               st, q_t, k_t, v_t, row_stride, mask_t, dout_t, lse_f,
                               (const float*)delta_f, static_cast<bf16*>(dq), grad_stride, S, H);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_clusters<DKV::N>(attention_bwd_tc_wide_dkv_kernel<DH>, grid, kThreads,
                                      DKV::kSmem, st, q_t, k_t, v_t, row_stride, mask_t, dout_t,
                                      lse_f, (const float*)delta_f, static_cast<bf16*>(dk),
                                      static_cast<bf16*>(dv), grad_stride, S, H);
}
