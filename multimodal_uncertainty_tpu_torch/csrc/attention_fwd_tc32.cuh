// Masked multi-head attention forward for Hopper (sm_90a) in fp32 at Dh 24-192,
// with and without dropout, on the tensor cores as split fp32 ("3xTF32").
//
// The kernel templates and their C entry point. Each attention_fwd_tc32*.cu
// file defines MMU_FWD_PLAIN_DIMS (and MMU_FWD_DROPOUT_DIMS) before including
// this header, so the instances compile in separate nvcc processes, started
// together (ops/_build.py):
//   * attention_fwd_tc32.cu     Dh 32, 64 and 128; dropout at 32 and 64;
//   * attention_fwd_tc32_k6.cu  Dh 24, 48, 96 and 192.
// bf16 runs on attention_fwd_tc.cuh (Dh 24-256) and attention_fwd_tc_wide.cuh
// (384 / 768); Dh 256 / 384 / 768 run attention_fwd_wide.cuh in fp32.
//
// Replaces these Pallas TPU kernels of multimodal_uncertainty_tpu/ops/attention.py
// in fp32:
//   * _sdpa_packed_fwd_impl :777 (K1) and _sdpa_flash_fwd_impl :1071 (K3):
//     FLAVA fusion at 8-32 heads, ViLT's 12 heads of 64;
//   * _sdpa_hl_fwd_impl :419 (K2) and _sdpa_hl_drop_fwd_impl :677 (K5):
//     BERT's 12 heads of 64 (2 of 32 for the tiny config), without and with
//     attention-probs dropout;
//   * _sdpa_pallas_fwd_impl :160 (K6): the heads-first forward JAX runs at Dh
//     24, 48 and 96; here the heads-last rows are read in place;
//   * _sdpa_flash_fwd_stream_impl :1488 (K4, through attention_flash) in fp32.
//
// Contract (that of attention_fwd_tc.cuh, in fp32). Per
// (batch, head): out = softmax_fp32(q k^T / sqrt(Dh) + bias) v, with bias = 0
// for kept keys and the finite -1e30 for masked ones, so a row whose keys are
// all masked averages V uniformly over all S keys; keys past S weigh exactly
// 0. lse = m + ln(l) per row, (B, H, S) fp32; a fully masked row writes
// exactly -1e30, which the backward kernels read as "fully masked". Dropout
// (DROPOUT = true): l and lse stay un-dropped, only P.V takes keep ? e *
// inv_keep : 0. q, k and v come through one row stride (the packed (B, S, 3D)
// projection is read in place); out is dense (B, S, D); offsets are 64-bit
// and any S works with no padding.
//
// What bounds it: 4 B S^2 D operations. On the fp32 FMA units that is 67
// TFLOP/s; SDPA in fp32 (TF32 off) runs there too. TF32 keeps 10 mantissa
// bits and one TF32 product misses the 1e-4 gate, so every fp32 operand x is
// split into two TF32 values, hi = tf32(x) and lo = tf32(x - hi) (cvt.rna),
// and each k8 step issues three wgmma.m64nNk8.f32.tf32.tf32 into one fp32
// accumulator, small terms first: A_lo B_hi, A_hi B_lo, A_hi B_hi (the
// dropped A_lo B_lo is ~2^-22 of the product). Bound: 3 x 4 B S^2 D at the
// 495 TFLOP/s TF32 rate, 0.41x the FMA bound. The second limit is the K and V
// tiles' traffic from L2: every block streams its head's K and V once.
//
// Design (FA2's loop on warpgroup products, with a producer warpgroup):
//   * a block is three warpgroups: two consumers, each owning 64 query rows
//     (128 a block), and a producer that copies the K and v tiles of BK keys
//     as they are into two raw buffers (cp.async, a tile ahead) and splits
//     them from there into a two-stage ring of hi and lo tiles, against a
//     "full" and an "empty" mbarrier a stage. The producer gives registers to
//     the consumers (setmaxnreg). On an H100 80GB HBM3 at 700 W
//     (tools/bench_attention.py, K4 in fp32 at B=1, S=16384): a first
//     version with one warpgroup of 64 rows a block, which split its own
//     tiles from device memory, took 18.1 ms, 7.0 of them without the splits;
//     128 rows a block with a producer halved the K and v traffic and splits a
//     row (15.5 ms), and its raw buffers hid the loads' latency (11.1 ms).
//   * S = q k^T: M = 64 rows, N = BK keys, K = Dh. The K tile is K-major in
//     its natural layout (Dh contiguous): the producer writes its hi and lo
//     tiles in the 128-byte swizzle, 32 tf32 values of Dh a 128-byte row, a
//     region of BK rows for each 32 of Dh (Dh 24 and 48 pad to 32 / 64; their
//     k-steps stop at Dh and never read the padding). A consumer splits its q
//     rows once, into registers, as wgmma's A fragments (Dh registers a thread).
//   * The online softmax runs on the accumulators in the exp2 domain: the
//     scale and log2(e) folded into one FMA with the key's bias (0, the masked
//     -1e30 log2(e), or -inf past S; the producer stages the tile's biases),
//     the row max over the four threads of a row by two shuffles, the row sum
//     a per-thread partial until the end.
//   * O += P v: tf32 wgmma takes B only K-major (transposition exists only for
//     16-bit types) and v arrives key-major, so the producer writes v
//     transposed, as Vt hi and lo tiles (rows = Dh, 32 keys a 128-byte row). P
//     goes back as register A fragments, split in registers. The A fragment of
//     a k8 step holds logical k = t and t + 4 (t = lane % 4), the accumulator
//     keys 2t and 2t + 1 of each 8-key block: so every 8-value group of k is
//     stored in the order 0, 2, 4, 6, 1, 3, 5, 7 (in Vt for the keys; in q's
//     fragments and the K tile, where the order of k within a step is free,
//     for one 8-byte load a q fragment pair). The accumulator's (2t, 2t + 1)
//     pair is then the fragment's (t, t + 4) as it stands: no shuffle, and the
//     permutation costs nothing, since the split writes Vt anyway.
//   * Dropout: each consumer thread loads its keep bytes (rows g and g + 8 of
//     its warp, keys 2t and 2t + 1 of each 8-key block) into a bit mask
//     before it waits for the tile, and applies it to P before the split.
//   * The first product of S (and of O on the first tile) uses scale-d 0, so
//     no zero fill defines an accumulator inside the pipeline.
// Budget (Tc32Layout<DH>): 64-key tiles at Dh <= 64 (K and Vt 28-64 KB a
// stage, the raw buffers 24-64 KB: at most 194 KB), 32-key tiles at Dh=96 (48
// KB a stage, 48 KB raw); registers: 232 a consumer thread (q's fragments, O,
// S and P's hi and lo), 40 a producer's. One block an SM.
//
// Dh 128 and 192 (attention_fwd_tc32_qs_kernel, Tc32QsLayout<DH>): q's split
// (Dh registers a thread) does not fit beside O (Dh / 2), so each consumer
// writes its rows' hi and lo tiles to shared memory once, K-major in the
// same swizzle and order as the K tile, and S = q k^T takes A from there. A
// stage of K and Vt would no longer fit twice beside q (a 32-key stage is 64
// KB at 128, 96 KB at 192), so K and Vt take turns:
// two slots of one tile each, K's and Vt's, each with its own full and empty
// mbarrier. The producer splits K of tile t + 1 while the consumers run the
// softmax and P v of tile t, and Vt of t + 1 while they run S of t + 1; the
// consumers free K's slot as soon as S and its biases are read. At Dh=128 two
// consumers (128 rows a block) and two raw buffers fit (225 KB); at Dh=192 one
// consumer (64 rows) and one raw buffer (217 KB).
//
// Row blocks: 128 rows at MMBT's S=165 compute 256 rows for 165 (64 %
// useful) against 192 (86 %) with 64-row blocks, but halve the K and v
// traffic and splits a row: 0.091 ms there against the 64-row version's 0.121
// (same card and tool).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 2;                      // warpgroups of 64 query rows
constexpr int kThreads = (kConsumers + 1) * 128;   // + the producer warpgroup
constexpr int kRows = kConsumers * 64;             // query rows a block
constexpr int kStages = 2;
// setmaxnreg moves registers only within the block's allocation at launch,
// kThreads x 168 (65536 / 384 rounded down to 8): a request past it never
// returns (48 a producer thread hung the kernel)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(128 * kProducerRegs + kConsumers * 128 * kConsumerRegs <= kThreads * 168,
              "registers");
constexpr float kMaskBias = -1e30f;      // ops/attention.py NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMaskBias2 = kMaskBias * kLog2e;

// Shared-memory layout of one instance with q in registers (Dh <= 96): a
// stage is the K and Vt hi and lo tiles (1024-byte aligned, each a number of
// 128-byte-swizzled regions) and the tile's key biases; the mbarriers follow
// the stages. Tiles of 64 keys, or 32 where a 64-key tile's S and P would not
// fit a consumer's registers beside q and O.
template <int DH>
struct Tc32Layout {
  static_assert(DH % 8 == 0 && DH <= 96, "head dims of whole 8-value groups, at most 96");
  static constexpr int BK = DH <= 64 ? 64 : 32;
  static constexpr int KP = (DH + 31) / 32 * 32;   // Dh padded to whole 128-byte rows
  static constexpr int KSTEPS = DH / 8;            // k8 steps of S = q k^T
  static constexpr int K_TILE = BK * KP * 4;       // K hi (or lo): KP / 32 regions of BK rows
  static constexpr int V_TILE = DH * BK * 4;       // Vt hi (or lo): BK / 32 regions of DH rows
  static constexpr int K_HI = 0, K_LO = K_TILE, V_HI = 2 * K_TILE, V_LO = V_HI + V_TILE,
                       BIAS = V_LO + V_TILE;
  static constexpr int STAGE = (BIAS + BK * 4 + 1023) / 1024 * 1024;
  static constexpr int RAW_TILE = BK * DH * 4;     // K (or v) as it arrives: BK rows of DH
  static constexpr int RAW = kStages * STAGE;      // two raw buffers of K and v
  static constexpr int BARS = RAW + 2 * 2 * RAW_TILE;  // full[kStages], empty[kStages]
  static constexpr int SMEM = BARS + 2 * kStages * 8 + 1024;  // + alignment
  static_assert(SMEM <= 232448, "the split-fp32 forward's shared memory");
  static_assert(BK % 32 == 0 && BK <= 64, "key tiles of whole 128-byte rows");
};

// Shared-memory layout of one instance with q in shared memory (Dh 128, 192):
// each consumer's q hi and lo tiles (Dh / 32 regions of 64 rows), one slot
// for K's hi and lo tiles, one for Vt's, the raw buffers, the tile's key
// biases, then full[2] and empty[2] (slot 0 K, slot 1 Vt). Every tile is
// 1024-byte aligned.
template <int DH>
struct Tc32QsLayout {
  static_assert(DH == 128 || DH == 192, "the head dims whose q split does not fit registers");
  static constexpr int BK = 32;
  static constexpr int KSTEPS = DH / 8;
  static constexpr int CONSUMERS = DH <= 128 ? 2 : 1;
  static constexpr int RAWS = DH <= 128 ? 2 : 1;      // raw buffers, each a K or v tile
  static constexpr int THREADS = (CONSUMERS + 1) * 128;
  static constexpr int Q_TILE = 64 * DH * 4;          // one consumer's q hi (or lo)
  static constexpr int TILE = BK * DH * 4;            // K or Vt hi (or lo), a raw K or v tile
  static constexpr int Q_HI = 0, Q_LO = CONSUMERS * Q_TILE, K_HI = 2 * Q_LO, K_LO = K_HI + TILE,
                       V_HI = K_LO + TILE, V_LO = V_HI + TILE, RAW = V_LO + TILE,
                       BIAS = RAW + RAWS * TILE, BARS = BIAS + BK * 4;
  static constexpr int SMEM = BARS + 4 * 8 + 1024;   // + alignment
  static_assert(SMEM <= 232448, "the split-fp32 forward's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a region of 128-byte rows: the 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// Descriptor of a K-major region at addr in the 128-byte swizzle: 8-row atoms
// of 128 bytes, 1 KB apart; a k8 step moves addr 32 bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// 16 bytes from global to shared memory, zero-filled when !valid (src must be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// v = hi + lo, each a tf32 value (cvt.rna; the 13 bits below tf32's mantissa
// are cleared, so that hi is exact in fp32 and v - hi is exact).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(v));
  h &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l) : "f"(v - __uint_as_float(h)));
  hi = h;
  lo = l & 0xffffe000u;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The max / sum of x over the four threads of a row (lanes 4 g .. 4 g + 3).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Keep the compiler from touching registers that an issued wgmma still owns.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// wgmma.m64nNk8.f32.tf32.tf32: rs with A from registers (four tf32 values a
// thread: rows g, g + 8 of the warp's 16 at logical k t, t, t + 4, t + 4), ss
// with A from a K-major shared-memory tile; B from a K-major tile. d is the m64nN fp32 accumulator: d[4 j + e] holds
// row g (e < 2) or g + 8, column 8 j + 2 t + (e & 1).
template <int N>
struct Mma;

template <>
struct Mma<24> {
  // d += a (registers) b; d = a b when acc == 0
  static __device__ __forceinline__ void rs(float (&d)[12], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Mma<32> {
  // d += a (registers) b; d = a b when acc == 0
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
  // d += a (a K-major shared-memory tile) b; d = a b when acc == 0
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Mma<48> {
  // d += a (registers) b; d = a b when acc == 0
  static __device__ __forceinline__ void rs(float (&d)[24], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Mma<64> {
  // d += a (registers) b; d = a b when acc == 0
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Mma<96> {
  // d += a (registers) b; d = a b when acc == 0
  static __device__ __forceinline__ void rs(float (&d)[48], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Mma<128> {
  // d += a (registers) b; d = a b when acc == 0
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};


template <>
struct Mma<192> {
  // d += a (registers) b; d = a b when acc == 0
  static __device__ __forceinline__ void rs(float (&d)[96], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

// The R rows of DH floats at src (row stride ld; rows from n_rows on read as
// zeros) split into the K-major hi and lo tiles at `hi` and `lo` (KP / 32
// regions of R rows) by the 128 threads tid of a warpgroup, each 8-value
// group in the order 0, 2, 4, 6, 1, 3, 5, 7.
template <int DH, int R>
__device__ __forceinline__ void split_rows(uint8_t* hi, uint8_t* lo, const float* src, long long ld,
                                           int n_rows, int tid) {
  constexpr int G = DH / 8;  // 8-value groups a row
#pragma unroll 2
  for (int i = tid; i < R * G; i += 128) {
    const int r = i / G, q = i % G;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (r < n_rows) {
      a = *reinterpret_cast<const float4*>(src + r * ld + 8 * q);
      b = *reinterpret_cast<const float4*>(src + r * ld + 8 * q + 4);
    }
    uint32_t h[8], l[8];
    split(a.x, h[0], l[0]);
    split(a.y, h[1], l[1]);
    split(a.z, h[2], l[2]);
    split(a.w, h[3], l[3]);
    split(b.x, h[4], l[4]);
    split(b.y, h[5], l[5]);
    split(b.z, h[6], l[6]);
    split(b.w, h[7], l[7]);
    const uint32_t region = (q / 4) * R * 128;
    const uint32_t c0 = region + swz(r, 2 * (q % 4)), c1 = region + swz(r, 2 * (q % 4) + 1);
    *reinterpret_cast<uint4*>(hi + c0) = make_uint4(h[0], h[2], h[4], h[6]);
    *reinterpret_cast<uint4*>(hi + c1) = make_uint4(h[1], h[3], h[5], h[7]);
    *reinterpret_cast<uint4*>(lo + c0) = make_uint4(l[0], l[2], l[4], l[6]);
    *reinterpret_cast<uint4*>(lo + c1) = make_uint4(l[1], l[3], l[5], l[7]);
  }
}

// The raw v tile `raw` (BK keys of DH floats) split and transposed into the
// K-major Vt hi and lo tiles (BK / 32 regions of DH rows: row d holds column
// d, 32 keys a 128-byte row) by the 128 threads tid of a warpgroup, each
// 8-key group in the order 0, 2, 4, 6, 1, 3, 5, 7. Consecutive threads take
// consecutive columns, so a warp's reads of one key row hit every bank once,
// and so do its 16-byte stores of eight consecutive rows.
template <int DH, int BK>
__device__ __forceinline__ void split_cols(uint8_t* hi, uint8_t* lo, const float* raw, int tid) {
#pragma unroll 2
  for (int i = tid; i < DH * (BK / 8); i += 128) {
    const int d = i % DH, q = i / DH;
    uint32_t h[8], l[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) split(raw[(8 * q + j) * DH + d], h[j], l[j]);
    const uint32_t region = (q / 4) * DH * 128;
    const uint32_t c0 = region + swz(d, 2 * (q % 4)), c1 = region + swz(d, 2 * (q % 4) + 1);
    *reinterpret_cast<uint4*>(hi + c0) = make_uint4(h[0], h[2], h[4], h[6]);
    *reinterpret_cast<uint4*>(hi + c1) = make_uint4(h[1], h[3], h[5], h[7]);
    *reinterpret_cast<uint4*>(lo + c0) = make_uint4(l[0], l[2], l[4], l[6]);
    *reinterpret_cast<uint4*>(lo + c1) = make_uint4(l[1], l[3], l[5], l[7]);
  }
}

// The biases of the BK keys from k0 in the exp2 domain (0 if kept, the masked
// -1e30 log2(e), -inf past S), written by the producer threads tid < BK.
template <int BK>
__device__ __forceinline__ void key_bias(float* dst, const uint8_t* key_mask, int k0, int S,
                                         int tid) {
  if (tid < BK) {
    const int key = k0 + tid;
    dst[tid] = key >= S ? -INFINITY : (key_mask && !key_mask[key] ? kMaskBias2 : 0.f);
  }
}

// The online softmax of one tile in the exp2 domain. sc is the tile's S = q
// k^T accumulator (m64n(8 NB)), kbias its keys' biases: the logits are sc
// scale_log2 + bias; m_run and l_run (rows g and g + 8) take the tile in,
// alpha is the factor that rescales O, and P's weights (keep ? e inv_keep : 0
// with dropout, bit 4 j + e of keep_bits for element e of 8-key block j) go
// to phi and plo, split, as the A fragments of O += P v.
template <int NB, bool DROPOUT>
__device__ __forceinline__ void tile_softmax(float (&sc)[4 * NB], const float* kbias, int t4,
                                             float scale_log2, uint32_t keep_bits, float inv_keep,
                                             float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2], uint32_t (&phi)[NB][4],
                                             uint32_t (&plo)[NB][4]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = fmaf(sc[4 * j + e], scale_log2, kbias[8 * j + 2 * t4 + (e & 1)]);
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_run[r], quad_max(mx[r]));  // finite: every tile has a key < S
    alpha[r] = ex2(m_run[r] - m_new);                       // 0 on the first tile
    m_run[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(sc[4 * j + e] - m_run[e >> 1]);
      rs[e >> 1] += p;
      float pv = p;  // the weight P.V takes
      if constexpr (DROPOUT) pv = (keep_bits >> (4 * j + e)) & 1u ? p * inv_keep : 0.f;
      // fragment of k-step j: (row g, key 2t) -> a0, (g + 8, 2t) -> a1, (g, 2t + 1) -> a2,
      // (g + 8, 2t + 1) -> a3
      split(pv, phi[j][(e & 1) * 2 + (e >> 1)], plo[j][(e & 1) * 2 + (e >> 1)]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = fmaf(l_run[r], alpha[r], rs[r]);
}

// O's rows g and g + 8 (an m64nDH accumulator) times alpha.
template <int DH>
__device__ __forceinline__ void rescale(float (&o)[DH / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
}

// out = O / l for rows lo_row and hi_row (those below S) of head h, and
// their lse; l_run is still this thread's part of the row sums.
template <int DH>
__device__ __forceinline__ void store_rows(const float (&o)[DH / 2], const float (&m_run)[2],
                                           float (&l_run)[2], float* __restrict__ out,
                                           float* __restrict__ lse, int b, int h, int H, int S,
                                           int lo_row, int hi_row, int t4) {
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] = quad_sum(l_run[r]);
    inv_l[r] = 1.f / l_run[r];
  }
  const int D = H * DH;
  float* o_base = out + (long long)b * S * D + (long long)h * DH;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (lo_row < S)
      *reinterpret_cast<float2*>(o_base + (long long)lo_row * D + col) =
          make_float2(o[4 * j] * inv_l[0], o[4 * j + 1] * inv_l[0]);
    if (hi_row < S)
      *reinterpret_cast<float2*>(o_base + (long long)hi_row * D + col) =
          make_float2(o[4 * j + 2] * inv_l[1], o[4 * j + 3] * inv_l[1]);
  }
  if (lse != nullptr && t4 == 0) {
    const long long stat_off = ((long long)b * H + h) * S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? hi_row : lo_row;
      // a fully masked row (its max is the masked bias) is -1e30 + ln(S) = -1e30 in fp32
      if (row < S)
        lse[stat_off + row] = m_run[r] <= 0.5f * kMaskBias2 ? kMaskBias
                                                            : m_run[r] * kLn2 + logf(l_run[r]);
    }
  }
}

// The kRows query rows of one (batch, head), looping over key tiles.
template <int DH, bool DROPOUT>
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_tc32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, long long row_stride,
                          const uint8_t* __restrict__ mask, const uint8_t* __restrict__ keep,
                          float inv_keep, float* __restrict__ out, float* __restrict__ lse, int S,
                          int H, float scale_log2) {
  using L = Tc32Layout<DH>;
  constexpr int BK = L::BK, KS = L::KSTEPS, NB = BK / 8;  // NB: 8-key blocks a tile
  static_assert(!DROPOUT || NB * 4 <= 32, "a tile's keep bits fit one word");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + kStages;

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long head_off = (long long)b * S * row_stride + (long long)h * DH;
  const int n_tiles = (S + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {  // the producer: split K and v tile by tile into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int tid = threadIdx.x - kConsumers * 128;
    const uint8_t* key_mask = mask ? mask + (long long)b * S : nullptr;
    // K and v of tile t as they are, into raw buffer t % 2 (cp.async, keys past S zero-filled)
    auto fetch = [&](int t) {
      const uint32_t raw = smem_u32(smem + L::RAW + (t % 2) * 2 * L::RAW_TILE);
      for (int i = tid; i < BK * (DH / 4); i += 128) {
        const int r = i / (DH / 4), c = (i % (DH / 4)) * 4;
        const int key = t * BK + r;
        const long long off = head_off + (long long)min(key, S - 1) * row_stride + c;
        cp_async16(raw + (r * DH + c) * 4, k + off, key < S);
        cp_async16(raw + L::RAW_TILE + (r * DH + c) * 4, v + off, key < S);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
    fetch(0);
    if (n_tiles > 1) fetch(1);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages, k0 = t * BK;
      if (t + 1 < n_tiles) {
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      }
      asm volatile("bar.sync 1, 128;" ::: "memory");  // every producer thread's copies are in
      if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);
      uint8_t* stage = smem + s * L::STAGE;
      const float* raw = reinterpret_cast<const float*>(smem + L::RAW + (t % 2) * 2 * L::RAW_TILE);
      split_rows<DH, BK>(stage + L::K_HI, stage + L::K_LO, raw, DH, BK, tid);
      split_cols<DH, BK>(stage + L::V_HI, stage + L::V_LO, raw + BK * DH, tid);
      key_bias<BK>(reinterpret_cast<float*>(stage + L::BIAS), key_mask, k0, S, tid);
      // the tiles, written through the generic proxy, are read by wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(&full[s]);
      if (t + 2 < n_tiles) {
        asm volatile("bar.sync 1, 128;" ::: "memory");  // every producer thread read raw t % 2
        fetch(t + 2);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows q0 + 64 wg .. + 63, warp w4 of it 16 of them
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int g = lane / 4, t4 = lane % 4;
  const int lo_row = q0 + (warp / 4) * 64 + (warp % 4) * 16 + g, hi_row = lo_row + 8;

  // q split once into A fragments: logical k t / t + 4 = physical 2t / 2t + 1 of each 8-group
  uint32_t qhi[KS][4], qlo[KS][4];
  {
    const float* p_lo = q + head_off + (long long)lo_row * row_stride + 2 * t4;
    const float* p_hi = q + head_off + (long long)hi_row * row_stride + 2 * t4;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float2 x = lo_row < S ? *reinterpret_cast<const float2*>(p_lo + 8 * kk)
                                  : make_float2(0.f, 0.f);
      const float2 y = hi_row < S ? *reinterpret_cast<const float2*>(p_hi + 8 * kk)
                                  : make_float2(0.f, 0.f);
      split(x.x, qhi[kk][0], qlo[kk][0]);
      split(y.x, qhi[kk][1], qlo[kk][1]);
      split(x.y, qhi[kk][2], qlo[kk][2]);
      split(y.y, qhi[kk][3], qlo[kk][3]);
    }
  }
  const uint8_t* keep_lo = nullptr;
  const uint8_t* keep_hi = nullptr;
  if constexpr (DROPOUT) {
    const uint8_t* keep_head = keep + ((long long)b * H + h) * S * S;
    keep_lo = keep_head + (long long)lo_row * S;
    keep_hi = keep_head + (long long)hi_row * S;
  }

  // per row (lo, hi): the running max (exp2 domain) and this thread's part of the running sum
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float o[DH / 2];  // no zero fill: the first tile's first product overwrites it
  uint32_t phi[NB][4], plo[NB][4];
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages, k0 = t * BK;
    // this thread's keep bits (bit 4 j + e: the accumulator's element e of 8-key block j),
    // loaded before the wait
    uint32_t keep_bits = 0;
    if constexpr (DROPOUT) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t4 + (e & 1);
          const bool in = key < S && (e < 2 ? lo_row : hi_row) < S;
          if (in && (e < 2 ? keep_lo : keep_hi)[key]) keep_bits |= 1u << (4 * j + e);
        }
    }
    mbar_wait(&full[s], (t / kStages) & 1);
    const uint8_t* stage = smem + s * L::STAGE;
    const uint32_t k_hi = smem_u32(stage + L::K_HI), k_lo = smem_u32(stage + L::K_LO);
    const uint32_t v_hi = smem_u32(stage + L::V_HI), v_lo = smem_u32(stage + L::V_LO);
    const float* kbias = reinterpret_cast<const float*>(stage + L::BIAS);

    // S = q k^T
    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t kb = (kk / 4) * BK * 128 + 32 * (kk % 4);
      Mma<BK>::rs(sc, qlo[kk], desc(k_hi + kb), kk > 0);
      Mma<BK>::rs(sc, qhi[kk], desc(k_lo + kb), 1);
      Mma<BK>::rs(sc, qhi[kk], desc(k_hi + kb), 1);
    }
    wgmma_commit();
    reg_fence(sc);
    wgmma_wait();
    reg_fence(sc);
    reg_fence(qhi);  // the last tile's products read q's fragments up to here
    reg_fence(qlo);

    // the online softmax; the old state's rescale
    float alpha[2];
    tile_softmax<NB, DROPOUT>(sc, kbias, t4, scale_log2, keep_bits, inv_keep, m_run, l_run, alpha,
                              phi, plo);
    if (t > 0) rescale<DH>(o, alpha);

    // O += P v
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const uint32_t vb = (j / 4) * DH * 128 + 32 * (j % 4);
      Mma<DH>::rs(o, plo[j], desc(v_hi + vb), t > 0 || j > 0);
      Mma<DH>::rs(o, phi[j], desc(v_lo + vb), 1);
      Mma<DH>::rs(o, phi[j], desc(v_hi + vb), 1);
    }
    wgmma_commit();
    reg_fence(o);
    wgmma_wait();
    reg_fence(o);
    reg_fence(phi);
    reg_fence(plo);
    mbar_arrive(&empty[s]);  // this thread's products are done with the stage
  }

  store_rows<DH>(o, m_run, l_run, out, lse, b, h, H, S, lo_row, hi_row, t4);
}

// The rows of one (batch, head) that Tc32QsLayout<DH> gives a block (64 a
// consumer), with q's hi and lo tiles in shared memory, looping over key
// tiles whose K and Vt take turns in two slots. No dropout instance: the
// dropout head dims are 32 and 64.
template <int DH>
__global__ void __launch_bounds__(Tc32QsLayout<DH>::THREADS, 1)
attention_fwd_tc32_qs_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, long long row_stride,
                             const uint8_t* __restrict__ mask, float* __restrict__ out,
                             float* __restrict__ lse, int S, int H, float scale_log2) {
  using L = Tc32QsLayout<DH>;
  constexpr int BK = L::BK, KS = L::KSTEPS, NB = BK / 8, C = L::CONSUMERS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);  // [0] K's slot, [1] Vt's
  uint64_t* empty = full + 2;

  const int q0 = blockIdx.x * C * 64, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long head_off = (long long)b * S * row_stride + (long long)h * DH;
  const int n_tiles = (S + BK - 1) / BK, n_items = 2 * n_tiles;  // item 2 t: K of tile t, 2 t + 1: v

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], C * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= C * 4) {  // the producer: split K and v item by item into their slots
    if constexpr (C > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int tid = threadIdx.x - C * 128;
    const uint8_t* key_mask = mask ? mask + (long long)b * S : nullptr;
    // item i as it is, into raw buffer i % RAWS (cp.async, keys past S zero-filled)
    auto fetch = [&](int i) {
      const float* src = i & 1 ? v : k;
      const uint32_t raw = smem_u32(smem + L::RAW + (i % L::RAWS) * L::TILE);
      for (int j = tid; j < BK * (DH / 4); j += 128) {
        const int r = j / (DH / 4), c = (j % (DH / 4)) * 4;
        const int key = (i / 2) * BK + r;
        cp_async16(raw + (r * DH + c) * 4,
                   src + head_off + (long long)min(key, S - 1) * row_stride + c, key < S);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
#pragma unroll
    for (int i = 0; i < L::RAWS; ++i) fetch(i);
    for (int i = 0; i < n_items; ++i) {
      const int t = i / 2, slot = i & 1;
      if (L::RAWS > 1 && i + 1 < n_items) {
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      }
      asm volatile("bar.sync 1, 128;" ::: "memory");  // every producer thread's copies are in
      if (t > 0) mbar_wait(&empty[slot], (t - 1) & 1);
      const float* raw = reinterpret_cast<const float*>(smem + L::RAW + (i % L::RAWS) * L::TILE);
      if (slot == 0) {
        split_rows<DH, BK>(smem + L::K_HI, smem + L::K_LO, raw, DH, BK, tid);
        key_bias<BK>(reinterpret_cast<float*>(smem + L::BIAS), key_mask, t * BK, S, tid);
      } else {
        split_cols<DH, BK>(smem + L::V_HI, smem + L::V_LO, raw, tid);
      }
      // the tiles, written through the generic proxy, are read by wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(&full[slot]);
      if (i + L::RAWS < n_items) {
        asm volatile("bar.sync 1, 128;" ::: "memory");  // every producer thread read the buffer
        fetch(i + L::RAWS);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows q0 + 64 wg .. + 63, warp w4 of it 16 of them
  if constexpr (C > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int r0 = q0 + wg * 64, lo_row = r0 + (warp % 4) * 16 + g, hi_row = lo_row + 8;

  // q's rows split once into this warpgroup's hi and lo tiles (rows past S zero)
  uint8_t* qh = smem + L::Q_HI + wg * L::Q_TILE;
  uint8_t* ql = smem + L::Q_LO + wg * L::Q_TILE;
  split_rows<DH, 64>(qh, ql, q + head_off + (long long)min(r0, S - 1) * row_stride, row_stride,
                     S - r0, threadIdx.x % 128);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
  const uint32_t q_hi = smem_u32(qh), q_lo = smem_u32(ql);
  const uint32_t k_hi = smem_u32(smem + L::K_HI), k_lo = smem_u32(smem + L::K_LO);
  const uint32_t v_hi = smem_u32(smem + L::V_HI), v_lo = smem_u32(smem + L::V_LO);
  const float* kbias = reinterpret_cast<const float*>(smem + L::BIAS);

  // per row (lo, hi): the running max (exp2 domain) and this thread's part of the running sum
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float o[DH / 2];  // no zero fill: the first tile's first product overwrites it
  uint32_t phi[NB][4], plo[NB][4];
  for (int t = 0; t < n_tiles; ++t) {
    // S = q k^T
    mbar_wait(&full[0], t & 1);
    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t kb = (kk / 4) * BK * 128 + 32 * (kk % 4);
      const uint32_t qa = (kk / 4) * 64 * 128 + 32 * (kk % 4);
      Mma<BK>::ss(sc, desc(q_lo + qa), desc(k_hi + kb), kk > 0);
      Mma<BK>::ss(sc, desc(q_hi + qa), desc(k_lo + kb), 1);
      Mma<BK>::ss(sc, desc(q_hi + qa), desc(k_hi + kb), 1);
    }
    wgmma_commit();
    reg_fence(sc);
    wgmma_wait();
    reg_fence(sc);

    // the online softmax, which reads the tile's biases; then K's slot is free
    float alpha[2];
    tile_softmax<NB, false>(sc, kbias, t4, scale_log2, 0u, 1.f, m_run, l_run, alpha, phi, plo);
    mbar_arrive(&empty[0]);
    if (t > 0) rescale<DH>(o, alpha);

    // O += P v
    mbar_wait(&full[1], t & 1);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const uint32_t vb = 32 * j;
      Mma<DH>::rs(o, plo[j], desc(v_hi + vb), t > 0 || j > 0);
      Mma<DH>::rs(o, phi[j], desc(v_lo + vb), 1);
      Mma<DH>::rs(o, phi[j], desc(v_hi + vb), 1);
    }
    wgmma_commit();
    reg_fence(o);
    wgmma_wait();
    reg_fence(o);
    reg_fence(phi);
    reg_fence(plo);
    mbar_arrive(&empty[1]);  // this thread's products are done with Vt's slot
  }

  store_rows<DH>(o, m_run, l_run, out, lse, b, h, H, S, lo_row, hi_row, t4);
}

template <int DH, bool DROPOUT>
cudaError_t launch(const void* q, const void* k, const void* v, long long row_stride,
                   const void* mask, const void* keep, float inv_keep, void* out, float* lse,
                   int B, int S, int H, cudaStream_t stream) {
  // 1 / sqrt(Dh) rounded once, as 1.0 / dh**0.5 is, then taken to the exp2 domain
  const float scale_log2 = (float)(1.0 / sqrt((double)DH)) * kLog2e;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const uint8_t* maskb = static_cast<const uint8_t*>(mask);
  cudaError_t err;
  if constexpr (DH > 96) {
    static_assert(!DROPOUT, "the dropout instances are Dh 32 and 64");
    using L = Tc32QsLayout<DH>;
    err = cudaFuncSetAttribute(attention_fwd_tc32_qs_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + L::CONSUMERS * 64 - 1) / (L::CONSUMERS * 64), H, B);
    attention_fwd_tc32_qs_kernel<DH><<<grid, L::THREADS, L::SMEM, stream>>>(
        qf, kf, vf, row_stride, maskb, static_cast<float*>(out), lse, S, H, scale_log2);
  } else {
    constexpr int smem = Tc32Layout<DH>::SMEM;
    err = cudaFuncSetAttribute(attention_fwd_tc32_kernel<DH, DROPOUT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + kRows - 1) / kRows, H, B);
    attention_fwd_tc32_kernel<DH, DROPOUT><<<grid, kThreads, smem, stream>>>(
        qf, kf, vf, row_stride, maskb, static_cast<const uint8_t*>(keep), inv_keep,
        static_cast<float*>(out), lse, S, H, scale_log2);
  }
  return cudaGetLastError();
}

template <int... DHS>
struct Dims {};

// The launch of the instance whose head dim is dh, among DHS; an invalid
// value when this library has none.
template <bool DROPOUT, int... DHS>
cudaError_t dispatch(Dims<DHS...>, int dh, const void* q, const void* k, const void* v,
                     long long row_stride, const void* mask, const void* keep, float inv_keep,
                     void* out, float* lse, int B, int S, int H, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((dh == DHS && ((err = launch<DHS, DROPOUT>(q, k, v, row_stride, mask, keep, inv_keep,
                                                    out, lse, B, S, H, stream)),
                        true)) || ...);
  return err;
}

}  // namespace

// Plain C entry point (loaded with ctypes), the arguments of
// attention_fwd_wide.cuh's mmu_attention_fwd: fp32 only (dtype 0). q, k, v:
// (B, S, H * dh) views with row stride row_stride (a multiple of 4 elements,
// 16-byte aligned bases); mask: (B, S) bytes, nonzero = key kept, or NULL for
// all kept; keep: (B, H, S, S) bytes of the dropout mask, nonzero =
// probability kept and scaled by inv_keep, or NULL for no dropout; out: dense
// (B, S, H * dh) fp32; lse: (B, H, S) float32 or NULL. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a dtype or head dim
// this library has no instance of).
extern "C" int mmu_attention_fwd(const void* q, const void* k, const void* v,
                                 long long row_stride, const void* mask, const void* keep,
                                 float inv_keep, void* out, void* lse, int B, int S, int H,
                                 int dh, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype != 0 || B < 1 || S < 1 || H < 1 || row_stride % 4) return (int)cudaErrorInvalidValue;
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (keep != nullptr)
    return (int)dispatch<true>(Dims<MMU_FWD_DROPOUT_DIMS>(), dh, q, k, v, row_stride, mask, keep,
                               inv_keep, out, lse_f, B, S, H, st);
  return (int)dispatch<false>(Dims<MMU_FWD_PLAIN_DIMS>(), dh, q, k, v, row_stride, mask, nullptr,
                              1.f, out, lse_f, B, S, H, st);
}
