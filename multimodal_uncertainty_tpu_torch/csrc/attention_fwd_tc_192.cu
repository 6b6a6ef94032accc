// Attention forward in bf16 at Dh=192, without dropout, on the tensor cores
// (attention_fwd_tc.cuh holds the kernel and its design notes): FLAVA fusion
// at 4 heads of D=768 under --bf16.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_pallas_fwd_impl
// :160 (pallas_call :167, body _attn_kernel :118; K6) at Dh 192, which the TPU
// runs heads-first; here the heads-last rows are read in place.
//
// A 384-byte row is three whole 64-column panels. O of 64 rows x 192 takes 96
// fp32 registers a thread, so q sits in shared memory (48 KB for 128 rows) as
// at Dh 256, beside a two-stage ring of 64-key K / V tiles (96 KB): one block
// an SM. O += P v is one m64n192k16 a step across the three panels (198
// registers, no spills).
// Raced against, in one call on an H100 80GB HBM3 at 700 W
// (tools/bench_attention.py, bf16, from copies of the tree with this define
// edited), at B=32, S=320 (ragged mask) / B=128, S=320: this shape 0.0608 /
// 0.1874 ms (0.0602 / 0.1860 in its second turn); q in registers (24 a
// thread) 0.0601 / 0.1917 (0.0602 / 0.1917); 32-key tiles 0.0700 / 0.2175
// (0.0701 / 0.2182); SDPA 0.0600-0.0607 / 0.1271-0.1306; the SIMT kernel this
// replaced 0.4441 at the first shape (an earlier call of the same tool).
#define MMU_FWD_TC_DH 192
#define MMU_FWD_TC_SHAPE 64, 0, 1
#include "attention_fwd_tc.cuh"
