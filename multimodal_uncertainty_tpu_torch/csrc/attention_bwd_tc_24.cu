// Attention backward in bf16 at Dh=24, without dropout, on the tensor cores
// (attention_bwd_tc.cuh holds the kernels and their design notes): FLAVA
// fusion at 32 heads of D=768 under --bf16.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_bwd_impl :253
// (pallas_call :261, body _attn_bwd_kernel :198; K6) at Dh 24, which the TPU
// runs heads-first; here the heads-last rows are read in place.
//
// A 48-byte row sits in one 64-column panel padded to 128 bytes. The K-major
// products (S = q k^T, dP = dO v^T and their transposes) take two k16 steps
// over columns 0..31: the tiles' columns 24..31 are zero-filled by the copy,
// and the own rows' A fragments there are zero (never read: they are the next
// head's columns, or past the end of out / dout / the packed projection). The
// MN-major ones (dQ, dK, dV) are m64n24k16. Both passes keep their own rows'
// operands in registers (8 a thread each) and stream 64-row tiles, two blocks
// an SM, so that one block's exponentials run beside the other's products
// (P is rebuilt in both passes: 8.4e8 exponentials at B=128, S=320, 0.23 ms
// at the SFU's rate). dQ pass 126 registers; dK/dV pass 128 with 108 bytes
// of spills, and ptxas serialises its wgmma (C7512): 32-row tiles there fit
// in 116 registers without either and ran slower all the same.
// Raced against, in one call on an H100 80GB HBM3 at 700 W
// (tools/bench_attention.py, B=128, S=320, from copies of the tree with the
// shapes edited): this shape 1.1823 ms (1.1749 in its second turn); 32-row
// tiles, three blocks an SM (152 bytes of spills) 1.4244 (1.4257); 64-row
// tiles, one block an SM 1.3620 (1.3637); SDPA's bf16 backward 1.1958-1.2077.
// In a second call: this shape 1.1739 (1.1810); 32-row tiles in both passes,
// two blocks an SM 1.3188 (1.3262); dK/dV alone over 32-row tiles 1.2227
// (1.2228); SDPA 1.1991-1.2041. The FMA kernel this replaced 7.5168 (an
// earlier call of the same tool).
#define MMU_BWD_TC_DH 24
#define MMU_BWD_TC_DQ 64, 1, 2
#define MMU_BWD_TC_DKV 1, 64, 1, 2
#include "attention_bwd_tc.cuh"
