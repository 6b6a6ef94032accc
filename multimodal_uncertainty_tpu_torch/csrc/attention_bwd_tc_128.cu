// Attention backward in bf16 at Dh=128, without dropout, on the tensor cores
// (attention_bwd_tc.cuh holds the kernels and their design notes): FLAVA
// fusion at 6 heads of D=768 under --bf16.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_bwd_impl
// :813 (K1, pallas_call :828) and _sdpa_flash_bwd_impl :1219 (K3, pallas_calls
// :1234, :1256) at 6 heads of 128.
//
// A 256-byte row is two whole 64-column panels. dQ pass: q and dO as A
// fragments (32 registers a thread each), dQ's 64 x 128 in 64, S and dP of a
// 64-key tile 32 each (240 registers). dK/dV pass, Dh 96's plan: dK and dV
// take 64 + 64 registers, so k and v stay in shared memory (64 KB for 128
// keys) and S^T, dP^T of a 64-query tile take 32 each (255 registers, no
// spills).
// Raced against, in one call on an H100 80GB HBM3 at 700 W
// (tools/bench_attention.py, from copies of the tree with the shapes edited),
// at B=128, S=320 / B=32, S=320 (ragged mask): this shape 0.6609 / 0.2071 ms
// (0.6641 / 0.2081 in its second turn); the dK/dV pass on column halves of
// whole panels with the P / dS exchange (SPLIT 2, as at Dh 256; 166
// registers) 0.7382 / 0.2246; that with q and dO in shared memory in the dQ
// pass 0.7352 / 0.2275, and over 32-key tiles there 0.7908 / 0.2466; the
// dK/dV pass over 32-query tiles with k and v in shared memory 0.7540 /
// 0.2330; SDPA's bf16 backward 0.4894-0.9338 / 0.1743-0.9209 (its readings
// spread); the FMA kernel this replaced 5.0164 / 1.3004.
#define MMU_BWD_TC_DH 128
#define MMU_BWD_TC_DQ 64, 1, 1
#define MMU_BWD_TC_DKV 1, 64, 0, 1
#include "attention_bwd_tc.cuh"
