// Attention forward in bf16 at Dh=768, without dropout, on the tensor cores
// (attention_fwd_tc_wide.cuh holds the kernel and its design notes): FLAVA
// fusion at 1 head of D=768 under --bf16.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_fwd_impl
// :777 (K1, pallas_call :788, body _attn_kernel_hl :348) and
// _sdpa_flash_fwd_impl :1071 (K3, pallas_call :1087, body
// _attn_kernel_flash_fwd :1000) at 1 head of 768.
//
// Clusters of 4 blocks, each 128 query rows (two warpgroups) and one 192-column
// slice of O (96 accumulators a thread), summing the slices' partial scores
// through distributed shared memory; 64-key tiles; q's slice in shared memory
// (210 KB in all, one block an SM). Raced against, in one call on an H100 80GB
// HBM3 at 700 W (tools/bench_attention.py, bf16, both head dims' shapes edited
// alike in copies of the tree), at B=32, S=320 with the ragged mask / B=128,
// S=320: this shape 0.1389 / 0.4677 ms (second turn 0.1382 / 0.4651); q's slice
// in registers (48 a thread; at Dh 768 255 registers and a 4-byte spill) 0.1383
// / 0.4691 (0.1376 / 0.4690); 32-key tiles 0.1661 / 0.5430 (0.1662 / 0.5444);
// (b) no cluster, each block one warpgroup scoring over all of Dh from q in
// shared memory and full-width 32-key K tiles, 0.1599 / 0.5264 (0.1589 /
// 0.5268); SDPA 0.1136-0.1143 / 0.3840-0.3865; the FMA cluster kernel this
// replaced 0.5610 / 1.9917.
#define MMU_FWD_TC_DH 768
#include "attention_fwd_tc_wide.cuh"
