// Attention backward in bf16 at Dh=192, without dropout, on the tensor cores
// (attention_bwd_tc.cuh holds the kernels and their design notes): FLAVA
// fusion at 4 heads of D=768 under --bf16.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_bwd_impl :253
// (pallas_call :261, body _attn_bwd_kernel :198; K6) at Dh 192, which the TPU
// runs heads-first; here the heads-last rows are read in place.
//
// A 384-byte row is three whole 64-column panels. dQ pass: as at Dh 256, q
// and dO in shared memory (48 KB each for 128 rows), dQ's 64 x 192 in 96
// registers a warpgroup thread. dK/dV pass: 64 x 192 of both dK and dV would
// take 192 registers a thread, and column halves of 192 would start
// warpgroup 1's columns 64 bytes into a 128-byte row, where an MN-major
// descriptor cannot start. So the two warpgroups split by role (SPLIT 3):
// both own the same 64 keys (k, v in shared memory, 24 KB each), each
// computes S^T and dP^T for half of a 64-query tile and hands P and dS over
// through the exchange, then warpgroup 0 takes dV += P^T dO and warpgroup 1
// dK += dS^T q, one m64n192k16 a step each (96 registers; the pass takes 192
// registers, the dQ pass 226, no spills, one block an SM each).
// Raced against, in one call on an H100 80GB HBM3 at 700 W
// (tools/bench_attention.py, B=128, S=320, from copies of the tree with the
// shapes edited): this shape 0.6590 ms (0.6601 in its second turn, 0.6607 /
// 0.6619 in two more copies); the dQ pass over 32-key tiles 0.7037 (0.6991);
// SDPA's bf16 backward 0.6887-0.6927; the FMA kernel this replaced 4.6248
// (an earlier call of the same tool).
#define MMU_BWD_TC_DH 192
#define MMU_BWD_TC_DQ 64, 0, 1
#define MMU_BWD_TC_DKV 3, 64, 0, 1
#include "attention_bwd_tc.cuh"
