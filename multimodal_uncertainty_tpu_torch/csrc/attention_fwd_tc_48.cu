// Attention forward in bf16 at Dh=48, without dropout, on the tensor cores
// (attention_fwd_tc.cuh holds the kernel and its design notes): FLAVA fusion
// at 16 heads of D=768 under --bf16.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_pallas_fwd_impl
// :160 (pallas_call :167, body _attn_kernel :118; K6) at Dh 48, which the TPU
// runs heads-first; here the heads-last rows are read in place.
//
// A 96-byte row sits in one 64-column panel padded to 128 bytes: S = q k^T
// takes three k16 steps that stop at Dh, O += P v one m64n48k16 a step inside
// the panel; nothing reads the padding. q in registers (12 a thread), O 24, S
// and P of a 64-key tile 32 and 16: two blocks an SM (113 registers, no
// spills).
// Raced against, in one call on an H100 80GB HBM3 at 700 W
// (tools/bench_attention.py, bf16, from copies of the tree with this define
// edited), at B=32, S=320 (ragged mask) / B=128, S=320: this shape 0.0714 /
// 0.2299 ms (0.0710 / 0.2288 in its second turn); 32-key tiles, three blocks
// an SM 0.0760 / 0.2470 (0.0762 / 0.2475); 32-key tiles, two blocks 0.0927 /
// 0.2863 (0.0927 / 0.2863); SDPA 0.0931-0.0947 / 0.2241-0.2302; the SIMT
// kernel this replaced 0.5475 at the first shape (an earlier call of the
// same tool).
#define MMU_FWD_TC_DH 48
#define MMU_FWD_TC_SHAPE 64, 1, 2
#include "attention_fwd_tc.cuh"
