// Attention backward in bf16 at Dh=96, without dropout, on the tensor cores
// (attention_bwd_tc.cuh holds the kernels and their design notes): FLAVA
// fusion at 8 heads of D=768 under --bf16.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_bwd_impl :253
// (pallas_call :261, body _attn_bwd_kernel :198; K6) at Dh 96, which the TPU
// runs heads-first; here the heads-last rows are read in place.
//
// A 192-byte row takes two 64-column panels, the second padded (a tile of 64
// rows is 16 KB), so that one swizzle serves the K-major reads (6 k16 steps,
// 4 in the first panel, 2 in the second) and the MN-major ones (n = 96 in one
// m64n96k16, across both panels by the leading-byte offset).
// dQ pass: q and dO in registers (24 a thread each), dQ 48, S and dP of a
// 64-key tile 32 each (220 registers). dK/dV pass: dK and dV take 48 + 48
// registers, so k and v stay in shared memory (64 KB for 128 keys) and S^T,
// dP^T of a 64-query tile take 32 each (240 registers). Raced against, in one
// call on an H100 80GB HBM3 at 700 W (tools/bench_attention.py), and removed:
// k and v in registers over 32-query tiles. At B=32, S=320 this shape
// 0.1960-0.1979 ms, the other 0.2228, SDPA's bf16 backward 0.1534-0.1550, the
// FMA kernel this replaced 1.3723-1.3752; at B=128, S=320 0.7151-0.7186, the
// other 0.8222, SDPA 0.5763-0.5805.
#define MMU_BWD_TC_DH 96
#define MMU_BWD_TC_DQ 64, 1, 1
#define MMU_BWD_TC_DKV 1, 64, 0, 1
#include "attention_bwd_tc.cuh"
