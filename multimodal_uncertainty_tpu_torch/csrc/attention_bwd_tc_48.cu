// Attention backward in bf16 at Dh=48, without dropout, on the tensor cores
// (attention_bwd_tc.cuh holds the kernels and their design notes): FLAVA
// fusion at 16 heads of D=768 under --bf16.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_bwd_impl :253
// (pallas_call :261, body _attn_bwd_kernel :198; K6) at Dh 48, which the TPU
// runs heads-first; here the heads-last rows are read in place.
//
// A 96-byte row sits in one 64-column panel padded to 128 bytes: the K-major
// products take three k16 steps that stop at Dh, the MN-major ones are
// m64n48k16 inside the panel; nothing reads the padding. Both passes keep
// their own rows' operands in registers (12 a thread each) and stream 32-row
// tiles, two blocks an SM (dQ pass 116 registers; dK/dV pass 128 with 16
// bytes of spills: dK and dV take 24 + 24).
// Raced against, in two calls on an H100 80GB HBM3 at 700 W
// (tools/bench_attention.py, B=128, S=320, from copies of the tree with the
// shapes edited). First call: 64-row tiles in both passes, dQ two blocks an
// SM and dK/dV one 0.9058 ms (0.9074 in its second turn); this shape 0.8589
// (0.8561); dQ over 64-row tiles, one block an SM, dK/dV over 32-row tiles,
// one block 1.1607 (1.1590); SDPA's bf16 backward 0.7047-0.7078. Second
// call: this shape 0.8617 (0.8606); dQ over 64-row tiles 0.8525 (0.8593, 128
// registers with 64 bytes of spills); dK/dV over 64-row tiles, one block an
// SM 0.9105 (0.9159); SDPA 0.7046-0.7095. The FMA kernel this replaced
// 6.3155 (an earlier call of the same tool).
#define MMU_BWD_TC_DH 48
#define MMU_BWD_TC_DQ 32, 1, 2
#define MMU_BWD_TC_DKV 1, 32, 1, 2
#include "attention_bwd_tc.cuh"
