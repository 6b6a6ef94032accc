// Attention forward in bf16 at Dh=96, without dropout, on the tensor cores
// (attention_fwd_tc.cuh holds the kernel and its design notes): FLAVA
// fusion at 8 heads of D=768 under --bf16.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_pallas_fwd_impl
// :160 (pallas_call :167, body _attn_kernel :118; K6) at Dh 96, which the TPU
// runs heads-first; here the heads-last rows are read in place.
//
// A 192-byte row takes two 64-column panels, the second padded (a 64-key
// tile is 16 KB), so that one swizzle serves the K-major reads of S = q k^T
// (6 k16 steps, 4 in the first panel, 2 in the second) and the MN-major ones
// of O += P v (n = 96 in one m64n96k16, across both panels by the
// leading-byte offset), as in attention_bwd_tc_k6.cu. q stays in registers
// (24 a thread), O takes 48, S and P of a 64-key tile 32 and 16: two blocks
// an SM (66.5 KB of shared memory each), at 128 registers with 104 bytes of
// spills. Raced against, in one call on an H100 80GB HBM3 at 700 W
// (tools/bench_attention.py, bf16, from copies of the tree with this
// define edited), at B=32, S=320 (ragged mask) / B=128, S=320 / B=32,
// S=736 (ragged): this shape 0.0629 / 0.2117 / 0.2330 ms (0.0635 / 0.2115 /
// 0.2332 in its second turn); 32-key tiles, two blocks an SM (no spills)
// 0.0662 / 0.2068 / 0.2504; 64-key tiles, one block an SM 0.0732 / 0.2378
// / 0.3150; 32-key tiles, one block 0.0982 / 0.3049 / 0.4188; SDPA
// 0.0635 / 0.1643 / 0.2129; the SIMT kernel this replaced 0.4203 at the
// first shape. In a second call, against blocks of one warpgroup (64 query
// rows), three an SM (157 registers, no spills), removed with its code:
// this shape 0.0626 / 0.2092 / 0.2312 (0.0626 / 0.2093 / 0.2312), that one
// 0.0630 / 0.1862 / 0.2476 (0.0633 / 0.1864 / 0.2473); SDPA 0.0628 / 0.1551
// / 0.2096.
#define MMU_FWD_TC_DH 96
#define MMU_FWD_TC_SHAPE 64, 1, 2
#include "attention_fwd_tc.cuh"
