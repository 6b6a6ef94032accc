// Weight gradient of a Linear for Hopper (sm_90a): dW = dY^T X, fp32 result.
//
// Replaces the Pallas TPU kernel multimodal_uncertainty_tpu/ops/dw.py::
// _dw_pallas_2d (body _dw_kernel), and tools/bench_dw.py::main.make_dw_pallas
// (the same product at the fusion MLP's K = 70144): dW = X^T dY over the
// K = B*S rows of a Linear's input X (K, Din) and output gradient dY (K, Dout),
// accumulated in fp32, for fp32 or bf16 inputs. The TPU kernel carried a
// (Din, bn) fp32 accumulator in VMEM across a sequential K grid axis and
// padded K with zero rows to its block. Here blocks run in parallel and in no
// order: each block owns one output tile and loops over its K range itself
// (the bf16 kernel: an equal share of the tiles' K stages, below);
// any K is taken, the ragged last stage zero-filled by the copy engine (TMA),
// with no padding copies.
//
// Layout: the result is written in torch's (Dout, Din) layout, the weight's
// own, so the autograd Function returns it with no transpose:
//     out[o][i] = sum_k dY[k][o] * X[k][i].
// Both operands arrive in their natural layout, contiguous along o and i (the
// "NT" case of a GEMM: A = dY^T is M x K with M = Dout, B = X is K x N with
// N = Din). X and dY may have any row stride the TMA takes (16-byte
// multiples, 16-byte aligned bases), so a strided view such as x[:, 0] (the
// pooler's input) is read in place.
//
// Three kernels; ops/dw.py::dw_route picks one by dtype and K. The two on
// the tensor cores run wgmma, fed by a ring of stages that one producer
// thread fills with TMA copies against a "full" mbarrier per stage, and two
// consumer warpgroups, each owning 64 rows of a 128 (Dout) x 256 (Din) output
// tile with its fp32 accumulators in registers (128 a thread), release on an
// "empty" one. A Din that is no multiple of 256 stores only its own columns.
// The tensor maps come from cuTensorMapEncodeTiled, fetched through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.
//
// * fp32, dw_kernel_tc32: split fp32 ("3xTF32"). Plain TF32 keeps 10 mantissa
//   bits and breaks the fp32 gate (1e-4 x max|plain|: one TF32 product at
//   K = 5920 errs ~0.1 against a gate of 0.037). Each fp32 operand is split
//   once, hi = tf32(v) and lo = tf32(v - hi) (cvt.rna), and every k8 step
//   issues three wgmma.m64n256k8.f32.tf32.tf32 into one accumulator, small
//   terms first: A_lo B_hi, A_hi B_lo, A_hi B_hi; the dropped A_lo B_lo is
//   ~2^-22 of the product, below fp32's own rounding. Bound: 3 x 2 K Din Dout
//   operations at the 495 TFLOP/s TF32 rate (0.169 ms at ViLT's fc1, K = 5920,
//   768 x 3072) against 0.417 ms for the plain product on the 67 TFLOP/s FMA
//   units. The layout trap: wgmma's transpose immediates exist only for
//   16-bit types, so both tf32 operands must be K-major, and TMA brings them
//   MN-major. The split is therefore also the transposition:
//     - A = dY^T goes to registers, as wgmma's A fragments (tf32 may take A
//       from registers). Each thread reads its elements of the fp32 stage (dY
//       in 32-column boxes, 128-byte swizzled) and splits them there.
//     - B = X is rewritten by the consumers, one column of X a thread, into
//       K-major hi and lo tiles in the 128-byte swizzle (32 tf32 values of k
//       make one 128-byte row; a k8 step moves the descriptor 32 bytes),
//       double-buffered so that the next stage's split overlaps this stage's
//       products.
//   The order of k within a k8 step and of the rows within a warp's 16 are
//   free (the sum over k does not care; the epilogue stores each row where it
//   belongs): logical k t and t + 4 of a step are k 2t and 2t + 1, logical
//   rows g and g + 8 of a warp are rows 2g and 2g + 1. So a thread's four A
//   elements of a step are two 8-byte loads, and with the swizzle a warp's
//   loads hit every bank once. Stage: 32 K rows, 16 KB of dY and 32 KB of X
//   (one 256 x 32 box, unswizzled: the split reads it along i); two stages and
//   two split buffers (64 KB each) make 224 KB of shared memory, one block an
//   SM. Each consumer splits stage t into buffer t % 2 while the tensor cores
//   run stage t - 1, waits for its own products of t - 1, loads its A
//   fragments, releases the stage and meets the other warpgroup at one named
//   barrier before issuing stage t's products. Shared memory is the second
//   limit: the products read 64 bytes of B a cycle at the full TF32 rate, the
//   split ~50 more of the 128 an SM serves. Registers: the producer is a
//   warpgroup of its own that gives its registers to the consumers
//   (setmaxnreg 40 / 232), and the tile's first product overwrites the
//   accumulators (scale-d 0) instead of a zero fill; either missing, ptxas
//   spills or serialises the wgmmas.
//
// * small K (the pooler's and cls_fc's K = batch 32, MMBT's image embedding's
//   96; ops/dw.py::SIMT_MAX_K, MMA_MAX_K): a few stages of a tensor-core
//   kernel leave most SMs idle on 18 tiles of 768 x 768, and the work is
//   writing the 2.4 MB fp32 output (0.0007 ms of bytes at K = 32). Small
//   output tiles (64 x 64: 144 blocks at 768 x 768, 384 at MMBT's 2048 x
//   768) fill the card; each block copies its X and dY columns' K slab into
//   shared memory with cp.async, with no K split, sums in fp32 registers and
//   stores the tile.
//   - fp32, dw_kernel_small: 64-row slabs on the FMA units (38 MFLOP at K =
//     32 is far below their ridge). On an H100 80GB HBM3 at 700 W
//     (tools/bench_attention.py, 768 x 768): 0.0049 ms at K = 32 (the 128 x
//     128 SIMT kernel it replaced: 0.0067; torch.matmul 0.0051; 32 x 64
//     tiles, 288 blocks, 0.0050), and ahead of the split kernel up to K = 128
//     (0.0110 against 0.0169), level at 192, behind at 256.
//   - bf16, dw_kernel_mma: one 128-row slab (two at K = 256), ldmatrix.trans
//     from the K-major slab rows (padded to 144 bytes, so a matrix's 8 rows
//     hit 8 bank groups) into mma.sync.m16n8k16 (bf16 in, fp32 sums), 8 warps
//     of 16 x 32 each. The same tiling on the FMA units (the fp32 kernel as a
//     template on the input type, widening bf16 as it reads) was raced and
//     lost at every K: 0.0052 against 0.0040 ms at K = 32, 0.0140 against
//     0.0076 at MMBT's K = 96, 2048 x 768, where 302 MFLOP keep the FMA
//     units busy (same call, H100 80GB HBM3, 700 W).
//
// * fp32 above SIMT_MAX_K, dw_kernel_tc32: 768 x 768 has only 18 output tiles
//   for 132 SMs, 768 x 3072 only 72. The wrapper therefore splits K over
//   `splits` blocks per tile (blockIdx.z; ops/dw.py::k_splits picks the count
//   so that the work units fill whole waves of the card); each writes its
//   partial tile to its own fp32 slab of a workspace, and a second kernel,
//   dw_reduce, sums the slabs in a fixed order, so the result does not depend
//   on scheduling (no atomics). With splits == 1 the tile goes straight to
//   the output.
//
// * bf16 above MMA_MAX_K, dw_kernel_tc: bf16 products are exact and the
//   tensor cores sum them in fp32, which is what JAX's
//   preferred_element_type=float32 gives; bound 2 K Din Dout at 989 TFLOP/s
//   (0.0489 ms at FLAVA's fc1, K = 10240, 768 x 3072; 0.335 at K = 70144). A
//   ring of 4 stages of 64 K-rows (48 KB a stage: 192 KB), wgmma.m64n256k16
//   with both operands MN-major in shared memory, read through the transpose
//   immediates: a 64 x 8 swizzle atom is 1 KB, the next 8 K-rows sit 1 KB on
//   (SBO) and the next 64 columns one box (8 KB) on (LBO), and one k16 step
//   moves the descriptor 2 KB. The model paths' K (5280-40960 rows on 18-72
//   tiles) fit no whole number of waves: a split of K leaves a wave part
//   empty (MMBT's fc1 at K = 5280: 72 blocks, 60 SMs idle) or writes the whole
//   output once a split and sums it in a second launch (FLAVA's fc1: 66 MB of
//   slabs beside 49 us of products). So the schedule is stream-K: one block
//   an SM, G = min(SMs, iterations), each running to the end over an equal
//   share of the (tile, 64-row stage) iterations (ops/dw.py::StreamKPlan; the
//   shares differ by one stage at most), its tiles in turn through one ring,
//   so the next tile's loads run under this one's epilogue. A tile that spans
//   blocks is summed without atomics and without a copy of the output a
//   split: the blocks holding its earlier stages each write one 128 x 256
//   fp32 partial to their own slot of a workspace (G slots, 16.5 MB at 132
//   SMs: it stays in L2) and set their flag (release); the block holding its
//   last stage waits on those flags (acquire), adds the partials in a fixed
//   order (by block index, downward) and stores the tile. The result is
//   therefore the same bit for bit from call to call. A block runs its range
//   from the top down, so its one partial (a range that stops inside a tile
//   stops there) is the first thing it does, and its one finish (a range
//   that starts inside a tile) the last: a finish never waits for a block
//   that is itself waiting (walked upward, each finish would wait for the
//   whole range of the block below, and the waits would chain across the
//   grid). Waiting needs every block resident: the launch is cooperative, so
//   a grid the card cannot hold is refused with an error instead of hanging.
//   The flags need no reset: each launch passes a new epoch and waits for
//   that value (the wrapper keeps the flags and the epoch per device and
//   stream). Where a tile-aligned grid (tiles x s blocks, every block inside
//   one tile) has a longest share within ops/dw.py::ALIGNED_SLACK of
//   stream-K's (768 x 768 and 768 x 2304: 18 and 54 tiles), it is taken
//   instead, and the s blocks of a tile each sum a slice of it over all s
//   partials, in block order: one finisher reading six partials at the end
//   of the run took longer. CUTLASS's hybrid (whole waves of data-parallel
//   tiles, stream-K only in the last) is the same schedule at every shape of
//   the model paths, which have fewer tiles (18-72) than SMs.
//   On an H100 80GB HBM3 at 700 W (tools/bench_attention.py, one call): 0.0794
//   ms at FLAVA's fc1 (the split kernel before: 0.0939; torch.matmul 0.0677).
//   The fixup is the gap: dropping the finisher's reads, then the partials'
//   writes, then the last stores gave 0.0734, 0.0697, 0.0670 (a tile's
//   middle blocks write their partials at the end of the run, so a finisher
//   waits for them). The tile-aligned grid at 768 x 768 (0.0370) is behind the
//   split kernel with its second launch (0.0319); sliced sums by the s = 7
//   blocks of a tile beat one finisher (0.0491).
//
// Left for later: TMA stores, clusters multicasting the shared operand.
#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;  // Din and Dout must be multiples of it
constexpr int BM = 128;    // output rows (o, Dout) per tile: 2 warpgroups x 64
constexpr int BN = 256;    // output columns (i, Din) per tile
constexpr int CONSUMERS = 2;  // warpgroups 0 and 1 run the products; a producer follows them

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

// After a split launch: sum the slabs of `workspace` into out (a no-op at
// splits == 1, whose tiles went straight to out). err is the launch's error.
cudaError_t reduce_slabs(cudaError_t err, const float* workspace, float* out, int Din, int Dout,
                         int splits, cudaStream_t st) {
  if (err != cudaSuccess || splits == 1) return err;
  const long long n4 = static_cast<long long>(Din) * Dout / 4;
  const int blocks = static_cast<int>(n4 / 256 + 1 < 4096 ? n4 / 256 + 1 : 4096);
  dw_reduce<<<blocks, 256, 0, st>>>(reinterpret_cast<const float4*>(workspace),
                                    reinterpret_cast<float4*>(out), n4, splits);
  return cudaGetLastError();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, through L2 only (cp.async.cg).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
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

// One 2-D TMA box (columns c0.., rows r0..) into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int r0,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(smem_u32(bar))
      : "memory");
}

// Keeps the compiler from moving the accumulators while wgmma owns them.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The 128 fp32 accumulators of an m64n256 wgmma: operands %0 .. %127.
#define DW_ACC_REGS                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "         \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "         \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "         \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "         \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "   \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "     \
  "%125, %126, %127}"
#define DW_ACC_OPERANDS(d)                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),           \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),           \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),           \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),           \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),           \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),           \
      "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),           \
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),           \
      "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),           \
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),           \
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),           \
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),           \
      "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),       \
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),     \
      "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),     \
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),     \
      "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// Store a warpgroup's 64 x 256 accumulator tile: acc[4 j + e] is column
// 8 j + 2 (lane % 4) + (e & 1) of row r0 (e < 2) or r1 (e >= 2), columns from
// i0; those at or past Din are not stored.
__device__ __forceinline__ void store_tile(const float (&acc)[128], float* r0, float* r1, int i0,
                                           int Din, int lane) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = i0 + 8 * j + 2 * (lane % 4);
    if (col < Din) {
      *reinterpret_cast<float2*>(r0 + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(r1 + col) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime already loaded (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a (rows, cols) matrix of `type` (elem bytes an element) with row
// stride ld elements, in boxes of box_rows x box_cols, zero-filled out of
// bounds.
bool make_map(CUtensorMap* map, const void* base, int rows, int cols, long long ld,
              CUtensorMapDataType type, int elem, int box_cols, int box_rows,
              CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch `kernel` on (ceil(Din / BN), Dout / BM, splits) blocks of `threads`
// with smem bytes of dynamic shared memory, then sum the slabs when K is split.
template <typename Kernel>
cudaError_t launch_split(Kernel kernel, int threads, int smem, const CUtensorMap& dy_map,
                         const CUtensorMap& x_map, float* out, float* workspace, int K, int Din,
                         int Dout, int splits, int k_chunk, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Din + BN - 1) / BN, Dout / BM, splits);
  float* target = splits > 1 ? workspace : out;
  kernel<<<grid, threads, smem, st>>>(dy_map, x_map, target, K, Din, Dout, k_chunk);
  return reduce_slabs(cudaGetLastError(), workspace, out, Din, Dout, splits, st);
}


// ---- fp32 at small K: the SIMT product on a grid that fills the card ----------

namespace simt {

constexpr int BM = 64;        // output rows (o, Dout) a tile
constexpr int BN = 64;        // output columns (i, Din) a tile
constexpr int KS = 64;        // K rows of a slab in shared memory
constexpr int THREADS = 256;  // 16 x 16: a thread owns 4 rows x 4 columns
constexpr int TM = BM / 16;

// grid (Din / BN, Dout / BM); block THREADS. The tile's dY and X columns come
// in slabs of KS rows (one slab at K <= KS), each copied whole by cp.async,
// then multiplied from shared memory: a thread sums its BM / 16 x 4 outputs
// in registers and stores them as float4s, 16 threads covering a 256-byte row.
__global__ void __launch_bounds__(THREADS)
dw_kernel_small(const float* __restrict__ x, long long ldx, const float* __restrict__ dy,
                long long ldy, float* __restrict__ out, int K, int Din) {
  __shared__ __align__(16) float As[KS][BM];  // dY slab: [k][o]
  __shared__ __align__(16) float Bs[KS][BN];  // X slab:  [k][i]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int o0 = blockIdx.y * BM, i0 = blockIdx.x * BN;

  float acc[TM][4];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KS) {
    const int rows = min(KS, K - k0);
    for (int i = tid; i < rows * (BM / 4); i += THREADS) {
      const int r = i / (BM / 4), c = (i % (BM / 4)) * 4;
      cp_async16(&As[r][c], dy + static_cast<long long>(k0 + r) * ldy + o0 + c);
    }
    for (int i = tid; i < rows * (BN / 4); i += THREADS) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      cp_async16(&Bs[r][c], x + static_cast<long long>(k0 + r) * ldx + i0 + c);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < rows; ++kk) {
      const float4 v = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float a[TM] = {v.x, v.y, v.z, v.w};
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        acc[r][0] = fmaf(a[r], b.x, acc[r][0]);
        acc[r][1] = fmaf(a[r], b.y, acc[r][1]);
        acc[r][2] = fmaf(a[r], b.z, acc[r][2]);
        acc[r][3] = fmaf(a[r], b.w, acc[r][3]);
      }
    }
    __syncthreads();  // the slab is read: the next copy may overwrite it
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    float* row = out + static_cast<long long>(o0 + ty * TM + r) * Din + i0;
    *reinterpret_cast<float4*>(row + tx * 4) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

cudaError_t launch(const void* x, long long ldx, const void* dy, long long ldy, float* out, int K,
                   int Din, int Dout, cudaStream_t st) {
  if (K == 0) return cudaMemsetAsync(out, 0, sizeof(float) * Din * Dout, st);
  if (ldx % 4 || ldy % 4 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(dy) % 16)
    return cudaErrorInvalidValue;
  dw_kernel_small<<<dim3(Din / BN, Dout / BM), THREADS, 0, st>>>(
      static_cast<const float*>(x), ldx, static_cast<const float*>(dy), ldy, out, K, Din);
  return cudaGetLastError();
}

}  // namespace simt


// ---- bf16 at small K: mma.sync on a grid that fills the card ------------------

namespace mma {

constexpr int BM = 64;        // output rows (o, Dout) a tile
constexpr int BN = 64;        // output columns (i, Din) a tile
constexpr int KS = 128;       // K rows of a slab in shared memory (two slabs at MMA_MAX_K)
constexpr int LD = BM + 8;    // a slab row in elements: 144 bytes, so ldmatrix's 8 rows
                              // fall in 8 different bank groups
constexpr int THREADS = 256;  // 8 warps: 4 (o) x 2 (i), each 16 x 32 of the tile

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d (16 x 8, fp32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid (Din / BN, Dout / BM); block THREADS. As the SIMT kernel, but the
// products run on the tensor cores: the tile's dY and X columns come in
// slabs of KS rows copied whole by cp.async (K-major: [k][o] and [k][i]),
// zero rows fill the slab up to a multiple of 16, and each warp reads its
// operands with ldmatrix.trans (A = dY^T, o x k; B = X, k x i, both from
// their K-major rows) into mma.m16n8k16 with fp32 sums.
__global__ void __launch_bounds__(THREADS)
dw_kernel_mma(const __nv_bfloat16* __restrict__ x, long long ldx,
              const __nv_bfloat16* __restrict__ dy, long long ldy, float* __restrict__ out, int K,
              int Din) {
  __shared__ __align__(16) __nv_bfloat16 As[KS][LD];  // dY slab: [k][o]
  __shared__ __align__(16) __nv_bfloat16 Bs[KS][LD];  // X slab:  [k][i]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int o0 = blockIdx.y * BM, i0 = blockIdx.x * BN;
  const int j = lane / 8, r = lane % 8;  // ldmatrix: this lane gives row r of matrix j

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += KS) {
    const int rows = min(KS, K - k0), padded = (rows + 15) & ~15;
    for (int i = tid; i < rows * (BM / 8); i += THREADS) {
      const int row = i / (BM / 8), c = (i % (BM / 8)) * 8;
      cp_async16(&As[row][c], dy + static_cast<long long>(k0 + row) * ldy + o0 + c);
      cp_async16(&Bs[row][c], x + static_cast<long long>(k0 + row) * ldx + i0 + c);
    }
    for (int i = rows * (BM / 8) + tid; i < padded * (BM / 8); i += THREADS) {
      const int row = i / (BM / 8), c = (i % (BM / 8)) * 8;
      *reinterpret_cast<uint4*>(&As[row][c]) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(&Bs[row][c]) = make_uint4(0, 0, 0, 0);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    for (int kk = 0; kk < padded; kk += 16) {
      // A: matrices (k 0-7, o 0-7), (k 0-7, o 8-15), (k 8-15, o 0-7), (k 8-15, o 8-15), the
      // fragments a0a1, a2a3, a4a5, a6a7; B: (k 0-7, i 0-7), (k 8-15, i 0-7), then i 8-15:
      // b0b1 and b2b3 of two 8-column tiles
      uint32_t a[4], b[2][4];
      ldsm_x4_trans(a, &As[kk + (j / 2) * 8 + r][wm * 16 + (j % 2) * 8]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ldsm_x4_trans(b[h], &Bs[kk + (j % 2) * 8 + r][wn * 32 + h * 16 + (j / 2) * 8]);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        mma16816(acc[n], a, b[n / 2][(n % 2) * 2], b[n / 2][(n % 2) * 2 + 1]);
    }
    __syncthreads();  // the slab is read: the next copy may overwrite it
  }
  // acc[n][0..1]: row g, columns 2 t, 2 t + 1 of the warp's 8-column tile n; [2..3]: row g + 8
  const int g = lane / 4, t = lane % 4;
  float* r0 = out + static_cast<long long>(o0 + wm * 16 + g) * Din + i0 + wn * 32 + 2 * t;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    *reinterpret_cast<float2*>(r0 + n * 8) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(r0 + 8LL * Din + n * 8) = make_float2(acc[n][2], acc[n][3]);
  }
}

cudaError_t launch(const void* x, long long ldx, const void* dy, long long ldy, float* out, int K,
                   int Din, int Dout, cudaStream_t st) {
  if (K == 0) return cudaMemsetAsync(out, 0, sizeof(float) * Din * Dout, st);
  if (ldx % 8 || ldy % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(dy) % 16)
    return cudaErrorInvalidValue;
  dw_kernel_mma<<<dim3(Din / BN, Dout / BM), THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), ldx, static_cast<const __nv_bfloat16*>(dy), ldy, out,
      K, Din);
  return cudaGetLastError();
}

}  // namespace mma


// ---- fp32: split fp32 (3xTF32) on wgmma + TMA --------------------------------

namespace tc32 {

constexpr int BK = 32;                              // K rows a stage: a 128-byte row of tf32
constexpr int STAGES = 2;
constexpr int A_BOX = 32;                           // dY columns a box: 128 bytes of fp32
constexpr int A_BOX_BYTES = A_BOX * BK * 4;         // 4 KB, 128-byte swizzled
constexpr int A_BYTES = BM / A_BOX * A_BOX_BYTES;   // dY: 16 KB a stage
constexpr int B_BYTES = BN * BK * 4;                // X: 32 KB a stage, one unswizzled box
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int HALF_BYTES = BN * BK * 4;             // the hi or the lo tile of X, K-major
constexpr int SPLIT_BYTES = 2 * HALF_BYTES;         // one split buffer
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * SPLIT_BYTES + 2 * STAGES * 8 + 1024;
static_assert(SMEM <= 232448, "the split-fp32 dW kernel's shared memory");
// The producer is a whole warpgroup (one thread of it issues the copies), so
// that registers move between warpgroups (setmaxnreg): 40 a producer thread,
// 232 a consumer's, for its 128 accumulators and 32 A fragment registers
// (without it every thread gets 168, as it did at 288 threads, and the
// products spill and serialise).
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + CONSUMERS * 128 * CONSUMER_REGS <= THREADS * 168,
              "registers: the block's allocation at launch, 384 threads x 168");

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile.
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// v = hi + lo, each a tf32 value (cvt.rna; the 13 bits below tf32's mantissa,
// which the tensor cores ignore, are cleared so that hi is exact in fp32).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(v));
  h &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l) : "f"(v - __uint_as_float(h)));
  hi = h;
  lo = l & 0xffffe000u;
}

// Keeps the A fragments in their registers until the wgmmas reading them are done.
__device__ __forceinline__ void fence_a(uint32_t (&a)[BK / 8][4]) {
#pragma unroll
  for (int q = 0; q < BK / 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[q][e])::"memory");
}

// Descriptor of a K-major tile at addr in the 128-byte swizzle: 8-row atoms
// of 128 bytes, 1 KB apart (SBO); a k8 step moves addr 32 bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 256, fp32) = a (64 x 8 tf32, register fragments) b (8 x 256 tf32,
// K-major in shared memory), + d when accumulate != 0.
__device__ __forceinline__ void wgmma_tf32(float (&d)[128], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 " DW_ACC_REGS
      ", {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : DW_ACC_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// grid (ceil(Din / BN), Dout / BM, splits); block THREADS; SMEM bytes of
// dynamic shared memory. dy_map: dY (K, Dout) in A_BOX x BK boxes, 128-byte
// swizzled; x_map: X (K, Din) in BN x BK boxes, unswizzled. Block z sums rows
// [z * k_chunk, min(K, (z + 1) * k_chunk)) into out + z * Dout * Din;
// k_chunk % BK == 0, so only the end of K is ragged, and no range is empty.
__global__ void __launch_bounds__(THREADS, 1)
dw_kernel_tc32(const __grid_constant__ CUtensorMap dy_map,
               const __grid_constant__ CUtensorMap x_map, float* __restrict__ out, int K,
               int Din, int Dout, int k_chunk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* bufs = smem + STAGES * STAGE_BYTES;  // the two split buffers
  uint64_t* full = reinterpret_cast<uint64_t*>(bufs + 2 * SPLIT_BYTES);
  uint64_t* empty = full + STAGES;

  const int o0 = blockIdx.y * BM;
  const int i0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  const int tiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  const int warp = threadIdx.x / 32;
  out += static_cast<long long>(blockIdx.z) * Dout * Din;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {  // the producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128) {
      for (int t = 0; t < tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        uint8_t* a = smem + s * STAGE_BYTES;
        const int k = kbeg + t * BK;
#pragma unroll
        for (int j = 0; j < BM / A_BOX; ++j)
          tma_load(a + j * A_BOX_BYTES, &dy_map, o0 + j * A_BOX, k, &full[s]);
        tma_load(a + A_BYTES, &x_map, i0, k, &full[s]);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns output rows o0 + 64 wg .. + 63, warp w4
  // of it 16 of them; thread tid splits column tid of X's stage
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int tid = threadIdx.x;
  const int wg = warp / 4, w4 = warp % 4, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  // this warp's 16 dY columns lie in box 2 wg + w4 / 2, 16-byte chunk c (+1
  // for g / 2 odd) of its rows; a thread's pair of columns at byte (g & 1) * 8
  const int a_box = (2 * wg + w4 / 2) * A_BOX_BYTES;
  const int a_chunk = 4 * (w4 % 2) + g / 2;
  // no zero fill: the tile's first product overwrites the accumulators (a fill
  // would be a non-wgmma definition of them inside the pipeline, and ptxas
  // would serialise every wgmma)
  float acc[128];
  uint32_t ahi[BK / 8][4] = {}, alo[BK / 8][4] = {};
  for (int t = 0; t < tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint8_t* stage = smem + s * STAGE_BYTES;
    // split X's column tid into K-major hi and lo rows: logical positions 8q ..
    // 8q + 3 of a row hold k = 8q + 0, 2, 4, 6; 8q + 4 .. 8q + 7 hold 8q + 1, 3, 5, 7
    // (the buffer was last read by stage t - 2's products, waited for before
    // the barrier of stage t - 1)
    const float* xs = reinterpret_cast<const float*>(stage + A_BYTES) + tid;
    uint8_t* hi = bufs + (t & 1) * SPLIT_BYTES;
    uint8_t* lo = hi + HALF_BYTES;
#pragma unroll
    for (int q = 0; q < BK / 8; ++q) {
      uint32_t h[8], l[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) split(xs[(8 * q + j) * BN], h[j], l[j]);
      *reinterpret_cast<uint4*>(hi + swz(tid, 2 * q)) = make_uint4(h[0], h[2], h[4], h[6]);
      *reinterpret_cast<uint4*>(hi + swz(tid, 2 * q + 1)) = make_uint4(h[1], h[3], h[5], h[7]);
      *reinterpret_cast<uint4*>(lo + swz(tid, 2 * q)) = make_uint4(l[0], l[2], l[4], l[6]);
      *reinterpret_cast<uint4*>(lo + swz(tid, 2 * q + 1)) = make_uint4(l[1], l[3], l[5], l[7]);
    }
    // stage t - 1's products are done: its A fragments may be overwritten
    wgmma_wait<0>();
    fence_acc(acc);
    fence_a(ahi);
    fence_a(alo);
    // A fragments of step q: a0 / a1 rows 2g / 2g + 1 at k 8q + 2 t4, a2 / a3 the
    // same rows at k 8q + 2 t4 + 1 (logical rows g, g + 8; logical k t4, t4 + 4)
#pragma unroll
    for (int q = 0; q < BK / 8; ++q) {
      const int r0 = 8 * q + 2 * t4, r1 = r0 + 1;
      const float2 v0 =
          *reinterpret_cast<const float2*>(stage + a_box + swz(r0, a_chunk) + (g & 1) * 8);
      const float2 v1 =
          *reinterpret_cast<const float2*>(stage + a_box + swz(r1, a_chunk) + (g & 1) * 8);
      split(v0.x, ahi[q][0], alo[q][0]);
      split(v0.y, ahi[q][1], alo[q][1]);
      split(v1.x, ahi[q][2], alo[q][2]);
      split(v1.y, ahi[q][3], alo[q][3]);
    }
    mbar_arrive(&empty[s]);  // this thread's reads of the stage are done
    // the split tiles, written through the generic proxy, are read by wgmma:
    // make them visible to it, then meet the other warpgroup's writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 128) : "memory");
    const uint32_t bh = smem_u32(hi), bl = smem_u32(lo);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < BK / 8; ++q) {
      wgmma_tf32(acc, alo[q], desc(bh + 32 * q), t > 0 || q > 0);
      wgmma_tf32(acc, ahi[q], desc(bl + 32 * q), 1);
      wgmma_tf32(acc, ahi[q], desc(bh + 32 * q), 1);
    }
    wgmma_commit();
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // logical rows g and g + 8 of warp w4 are rows 2g and 2g + 1 of its 16
  float* r0 = out + static_cast<long long>(o0 + wg * 64 + w4 * 16 + 2 * g) * Din;
  store_tile(acc, r0, r0 + Din, i0, Din, lane);
}

cudaError_t launch(const void* x, long long ldx, const void* dy, long long ldy, float* out,
                   float* workspace, int K, int Din, int Dout, int splits, int k_chunk,
                   cudaStream_t st) {
  if (K == 0) return cudaMemsetAsync(out, 0, sizeof(float) * Din * Dout, st);
  if (k_chunk % BK || static_cast<long long>(splits - 1) * k_chunk >= K || ldx % 4 || ldy % 4 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(dy) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap dy_map, x_map;
  if (!make_map(&dy_map, dy, K, Dout, ldy, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, A_BOX, BK,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&x_map, x, K, Din, ldx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, BN, BK,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  return launch_split(dw_kernel_tc32, THREADS, SMEM, dy_map, x_map, out, workspace, K, Din, Dout,
                      splits, k_chunk, st);
}

}  // namespace tc32


// ---- bf16: stream-K on wgmma + TMA ------------------------------------------

namespace tc {

constexpr int BK = 64;                        // K rows per stage
constexpr int BOX = 64;                       // columns of one TMA box: 128 bytes of bf16
constexpr int STAGES = 4;
constexpr int BOX_BYTES = BOX * BK * 2;       // 8 KB
constexpr int A_BYTES = BM / BOX * BOX_BYTES;  // dY: 16 KB a stage
constexpr int B_BYTES = BN / BOX * BOX_BYTES;  // X: 32 KB a stage
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // + barriers, + alignment
constexpr int THREADS = CONSUMERS * 128 + 32;  // warp 8 is the producer
constexpr int PARTIAL = BM * BN;              // floats of one partial tile in the workspace
constexpr int PARTIAL_F4 = PARTIAL / 4;

// wgmma shared-memory descriptor of an MN-major operand in 128-byte swizzle:
// start address, LBO = one box (the next 64 columns), SBO = 8 rows of 128 bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(BOX_BYTES >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 256, fp32) = A (64 x 16) B (16 x 256) (+ d when accumulate != 0),
// both bf16 in shared memory, both MN-major (transpose immediates 1, 1).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " DW_ACC_REGS
      ", %128, %129, p, 1, 1, 1, 1;\n}\n"
      : DW_ACC_OPERANDS(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Row of a 128 x 256 tile that consumer thread t's accumulators acc[4 j],
// acc[4 j + 1] hold (acc[4 j + 2], acc[4 j + 3]: 8 rows down): rows 16 w +
// lane / 4 of its warpgroup's 64.
__device__ __forceinline__ int tile_row(int t) {
  return (t / 128) * 64 + ((t % 128) / 32) * 16 + (t % 32) / 4;
}

// The plan (ops/dw.py::stream_k_plan and StreamKPlan, the same integers):
// tiles = (Dout / BM) ceil(Din / BN) output tiles, tile t at rows BM (t / n_i),
// columns BN (t % n_i); stages = ceil(K / BK) a tile; iters = tiles x stages
// (tile, stage) iterations, numbered tile by tile; block b of G takes
// [iters b / G, iters (b + 1) / G).
struct Plan {
  int n_i, stages;
  long long iters;
  bool aligned;  // G a multiple of the tiles: every block's range lies in one tile
  __device__ Plan(int K, int Din, int Dout)
      : n_i((Din + BN - 1) / BN), stages((K + BK - 1) / BK),
        iters(static_cast<long long>((Din + BN - 1) / BN) * (Dout / BM) * ((K + BK - 1) / BK)),
        aligned(gridDim.x % ((Din + BN - 1) / BN * (Dout / BM)) == 0) {}
  __device__ long long lo(int b) const { return iters * b / gridDim.x; }
};

// Spin until *flag holds epoch (acquire), then fence. A flag that never comes
// (a fault in another block) ends the kernel with an error after some
// seconds instead of holding the card.
__device__ __forceinline__ void wait_flag(const unsigned* flag, unsigned epoch) {
  for (long long polls = 0; ld_acquire(flag) != epoch; ++polls)
    if (polls > (1ll << 28)) __trap();
  __threadfence();
}

// grid G <= SMs (one block an SM, all resident: a cooperative launch); block
// THREADS; SMEM bytes of dynamic shared memory. dy_map and x_map are the
// tensor maps of dY (K, Dout) and X (K, Din) with 64 x BK boxes. ws holds G
// partial tiles (PARTIAL floats each, in the accumulators' order: float4 j of
// consumer thread t at j * 256 + t, so each store and load is a warp's 512
// bytes), one a block; flags G words, block b's set to `epoch` once its
// partial is written (no launch resets them: each passes a new epoch). Block
// b runs its segments from the top of its range down, stage by stage through
// the ring; a tile's first product overwrites the accumulators (scale-d 0).
// At a segment's last stage a whole tile is stored. Otherwise:
// - stream-K grid: a segment that stops inside its tile (only the top one
//   can: the block's first work) is written to slot b and flagged; the block
//   holding the tile's last stage (its bottom segment: its last work, so the
//   ring is free) copies the partials of blocks b - 1, b - 2, ... that hold
//   the tile's earlier stages into the ring one at a time, each after its
//   flag, adds them in that order and stores the tile;
// - aligned grid (G a multiple of the tiles, so each block lies in one tile):
//   every block of a tile writes its partial and flags it, and block bl + j of
//   the tile's n sums float4s [PARTIAL_F4 j / n, PARTIAL_F4 (j + 1) / n) of
//   the n partials in block order, all n slices copied into the ring at once.
// Every flag is set before its block waits on any, so no wait waits on a
// waiting block.
__global__ void __launch_bounds__(THREADS, 1)
dw_kernel_tc(const __grid_constant__ CUtensorMap dy_map, const __grid_constant__ CUtensorMap x_map,
             float* __restrict__ out, float* __restrict__ ws, unsigned* __restrict__ flags,
             unsigned epoch, int K, int Din, int Dout) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const Plan plan(K, Din, Dout);
  const int b = blockIdx.x;
  const long long lo = plan.lo(b), hi = plan.lo(b + 1);
  const long long first = (hi - 1) / plan.stages, last = lo / plan.stages;  // tiles, top down
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {  // the producer: one thread keeps the ring full, across tiles
    if (threadIdx.x % 32 == 0) {
      int c = 0;  // ring position
      for (long long tile = first; tile >= last; --tile) {
        const long long t0 = tile * plan.stages;
        const int s0 = static_cast<int>(max(lo, t0) - t0);
        const int s1 = static_cast<int>(min(hi, t0 + plan.stages) - t0);
        const int o0 = static_cast<int>(tile / plan.n_i) * BM;
        const int i0 = static_cast<int>(tile % plan.n_i) * BN;
        const int x_boxes = min(BN, Din - i0) / BOX;  // boxes past Din are not loaded
        const uint32_t bytes = A_BYTES + x_boxes * BOX_BYTES;
        for (int s = s0; s < s1; ++s, ++c) {
          const int slot = c % STAGES;
          if (c >= STAGES) mbar_wait(&empty[slot], (c / STAGES - 1) & 1);
          mbar_expect_tx(&full[slot], bytes);
          uint8_t* a = smem + slot * STAGE_BYTES;
#pragma unroll
          for (int j = 0; j < BM / BOX; ++j)
            tma_load(a + j * BOX_BYTES, &dy_map, o0 + j * BOX, s * BK, &full[slot]);
          for (int j = 0; j < x_boxes; ++j)
            tma_load(a + A_BYTES + j * BOX_BYTES, &x_map, i0 + j * BOX, s * BK, &full[slot]);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns output rows o0 + 64 wg .. + 63
  const int tid = threadIdx.x, wg = warp / 4, lane = tid % 32;
  float4* stage = reinterpret_cast<float4*>(smem);  // the ring, once this block's stages are in
  float acc[128];
  int c = 0;
  for (long long tile = first; tile >= last; --tile) {
    const long long t0 = tile * plan.stages;
    const int s0 = static_cast<int>(max(lo, t0) - t0);
    const int s1 = static_cast<int>(min(hi, t0 + plan.stages) - t0);
    for (int s = s0; s < s1; ++s, ++c) {
      const int slot = c % STAGES;
      mbar_wait(&full[slot], (c / STAGES) & 1);
      const uint32_t a = smem_u32(smem + slot * STAGE_BYTES + wg * BOX_BYTES);
      const uint32_t bb = smem_u32(smem + slot * STAGE_BYTES + A_BYTES);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n256k16(acc, desc(a + kk * 2048), desc(bb + kk * 2048), s > s0 || kk > 0);
      wgmma_commit();
      fence_acc(acc);
      // the previous stage's products are done: hand it back to the producer
      wgmma_wait<1>();
      fence_acc(acc);
      if (s > s0) mbar_arrive(&empty[(c - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive(&empty[(c - 1) % STAGES]);  // the tile's last stage; the producer goes on

    const int o0 = static_cast<int>(tile / plan.n_i) * BM;
    const int i0 = static_cast<int>(tile % plan.n_i) * BN;
    if (s0 > 0 && s1 == plan.stages && !plan.aligned) {
      // finish: add the partials of the blocks below that hold the tile's earlier stages,
      // each copied whole into the ring (free: this is the block's last segment)
      for (int p = b - 1; p >= 0 && plan.lo(p + 1) > t0; --p) {
        if (tid == 0) wait_flag(&flags[p], epoch);
        asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 128) : "memory");
        const float4* w =
            reinterpret_cast<const float4*>(ws) + static_cast<long long>(p) * PARTIAL_F4;
        for (int f = tid; f < PARTIAL_F4; f += CONSUMERS * 128) cp_async16(stage + f, w + f);
        asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
#pragma unroll
        for (int j = 0; j < 32; ++j) {  // this thread's own float4s: no barrier needed before
          const float4 v = stage[j * CONSUMERS * 128 + tid];
          acc[4 * j] += v.x;
          acc[4 * j + 1] += v.y;
          acc[4 * j + 2] += v.z;
          acc[4 * j + 3] += v.w;
        }
        asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 128) : "memory");  // ring free again
      }
    }
    if (s1 == plan.stages && (s0 == 0 || !plan.aligned)) {  // whole, or finished above
      float* r0 = out + static_cast<long long>(o0 + tile_row(tid)) * Din;
      store_tile(acc, r0, r0 + 8LL * Din, i0, Din, lane);
      continue;
    }
    // a partial, into the block's slot: float4 j of thread t (acc[4 j .. 4 j + 3]) at
    // j * 256 + t, each store a warp's 512 bytes; then the block's flag
    float4* w = reinterpret_cast<float4*>(ws) + static_cast<long long>(b) * PARTIAL_F4 + tid;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      w[j * CONSUMERS * 128] =
          make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 128) : "memory");
    if (tid == 0) {
      __threadfence();
      st_release(&flags[b], epoch);
    }
    if (!plan.aligned) continue;  // the block holding the tile's last stage sums it
    // aligned: this block's one segment; blocks bl .. bh (n) hold the tile, and block bl + j
    // sums float4s [PARTIAL_F4 j / n, PARTIAL_F4 (j + 1) / n) of their n partials: all n
    // slices (one tile's worth of bytes) copied into the ring at once, summed in block order
    int bl = b, bh = b;
    while (plan.lo(bl) > t0) --bl;
    while (plan.lo(bh + 1) < t0 + plan.stages) ++bh;
    const int n = bh - bl + 1;
    if (tid < n && bl + tid != b) wait_flag(&flags[bl + tid], epoch);  // all polled at once
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 128) : "memory");
    const int f0 = PARTIAL_F4 * (b - bl) / n, m = PARTIAL_F4 * (b - bl + 1) / n - f0;
    for (int q = 0; q < n; ++q) {
      const float4* src =
          reinterpret_cast<const float4*>(ws) + static_cast<long long>(bl + q) * PARTIAL_F4 + f0;
      for (int f = tid; f < m; f += CONSUMERS * 128) cp_async16(stage + q * m + f, src + f);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 128) : "memory");
    for (int f = tid; f < m; f += CONSUMERS * 128) {
      float4 sum = stage[f];
      for (int q = 1; q < n; ++q) {
        const float4 v = stage[q * m + f];
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      // float4 j of thread t: row tile_row(t), columns c, c + 1, and 8 rows down
      const int j = (f0 + f) / (CONSUMERS * 128), t = (f0 + f) % (CONSUMERS * 128);
      const int col = i0 + 8 * j + 2 * (t % 4);
      if (col < Din) {
        float* r0 = out + static_cast<long long>(o0 + tile_row(t)) * Din + col;
        *reinterpret_cast<float2*>(r0) = make_float2(sum.x, sum.y);
        *reinterpret_cast<float2*>(r0 + 8LL * Din) = make_float2(sum.z, sum.w);
      }
    }
  }
}

// A cooperative launch of `grid` blocks: refused (an error, not a hang) when
// the card cannot hold them all at once, which the finishing blocks' waits
// need.
cudaError_t launch(const void* x, long long ldx, const void* dy, long long ldy, float* out,
                   float* workspace, unsigned* flags, unsigned epoch, int K, int Din, int Dout,
                   int grid, cudaStream_t st) {
  if (K == 0) return cudaMemsetAsync(out, 0, sizeof(float) * Din * Dout, st);
  const long long iters =
      static_cast<long long>((Din + BN - 1) / BN) * (Dout / BM) * ((K + BK - 1) / BK);
  if (grid < 1 || grid > iters || workspace == nullptr || flags == nullptr || epoch == 0 ||
      ldx % 8 || ldy % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(dy) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap dy_map, x_map;
  if (!make_map(&dy_map, dy, K, Dout, ldy, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, BOX, BK,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&x_map, x, K, Din, ldx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, BOX, BK,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(dw_kernel_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dw_kernel_tc, dy_map, x_map, out, workspace, flags, epoch, K,
                           Din, Dout);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x (K, Din) with row stride ldx, dy (K, Dout) with row stride ldy ->
// out (Dout, Din) fp32, dense. Din and Dout are multiples of 128; bases
// 16-byte aligned. `route`:
//   0, fp32 on dw_kernel_tc32: `parts` K splits of k_chunk rows (a multiple
//      of 32, none empty), `workspace` parts * Dout * Din floats when parts > 1
//      (else it may be null); row strides multiples of 4 elements;
//   1, bf16 on the stream-K dw_kernel_tc: `parts` blocks (ops/dw.py::
//      stream_k_plan's grid, at most the (tile, stage) iterations and the SMs),
//      `workspace` parts * 128 * 256 floats, `flags` at least parts words that
//      no other launch uses meanwhile, `epoch` a value none of them holds
//      (k_chunk unused); row strides multiples of 8 elements;
//   2, fp32 on the small-K dw_kernel_small: parts 1, the whole K; row strides
//      multiples of 4 elements;
//   3, bf16 on the small-K dw_kernel_mma: parts 1, the whole K; row strides
//      multiples of 8 elements.
// Returns the launch's CUDA error code.
extern "C" int mmu_dw(const void* x, long long ldx, const void* dy, long long ldy, void* out,
                      void* workspace, void* flags, int K, int Din, int Dout, int parts,
                      int k_chunk, unsigned epoch, int route, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Din % TILE || Dout % TILE || parts < 1 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* ws = static_cast<float*>(workspace);
  if (route == 0) {
    err = k_chunk < 1 || (parts > 1 && ws == nullptr)
              ? cudaErrorInvalidValue
              : tc32::launch(x, ldx, dy, ldy, o, ws, K, Din, Dout, parts, k_chunk, st);
  } else if (route == 1) {
    err = tc::launch(x, ldx, dy, ldy, o, ws, static_cast<unsigned*>(flags), epoch, K, Din, Dout,
                     parts, st);
  } else if (route == 2) {
    err = parts != 1 ? cudaErrorInvalidValue : simt::launch(x, ldx, dy, ldy, o, K, Din, Dout, st);
  } else if (route == 3) {
    err = parts != 1 ? cudaErrorInvalidValue : mma::launch(x, ldx, dy, ldy, o, K, Din, Dout, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
