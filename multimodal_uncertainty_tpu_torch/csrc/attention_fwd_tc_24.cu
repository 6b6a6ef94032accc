// Attention forward in bf16 at Dh=24, without dropout, on the tensor cores
// (attention_fwd_tc.cuh holds the kernel and its design notes): FLAVA fusion
// at 32 heads of D=768 under --bf16.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_pallas_fwd_impl
// :160 (pallas_call :167, body _attn_kernel :118; K6) at Dh 24, which the TPU
// runs heads-first; here the heads-last rows are read in place.
//
// A 48-byte row sits in one 64-column panel padded to 128 bytes. S = q k^T
// takes two k16 steps over columns 0..31: the tile's columns 24..31 are
// zero-filled by the copy and q's A fragments there are zero (never read from
// memory: they are the next head's columns, or past the tensor's end). O += P v
// is one m64n24k16 a step. q in registers (8 a thread), O 12, S and P of a
// 64-key tile 32 and 16: two blocks an SM (112 registers, no spills).
// Raced against, in one call on an H100 80GB HBM3 at 700 W
// (tools/bench_attention.py, bf16, from copies of the tree with this define
// edited), at B=32, S=320 (ragged mask) / B=128, S=320: this shape 0.1105 /
// 0.3654 ms (0.1093 / 0.3636 in its second turn); 32-key tiles, three blocks
// an SM 0.1192 / 0.3992 (0.1199 / 0.3994); 32-key tiles, two blocks 0.1198 /
// 0.3998 (0.1196 / 0.3998); SDPA 0.1776-0.1802 / 0.4387-0.4529; the SIMT
// kernel this replaced 0.7271 at the first shape (an earlier call of the
// same tool).
#define MMU_FWD_TC_DH 24
#define MMU_FWD_TC_SHAPE 64, 1, 2
#include "attention_fwd_tc.cuh"
