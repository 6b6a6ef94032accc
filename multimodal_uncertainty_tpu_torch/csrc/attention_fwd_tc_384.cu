// Attention forward in bf16 at Dh=384, without dropout, on the tensor cores
// (attention_fwd_tc_wide.cuh holds the kernel and its design notes): FLAVA
// fusion at 2 heads of D=768 under --bf16.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_fwd_impl
// :777 (K1, pallas_call :788, body _attn_kernel_hl :348) and
// _sdpa_flash_fwd_impl :1071 (K3, pallas_call :1087, body
// _attn_kernel_flash_fwd :1000) at 2 heads of 384.
//
// Clusters of 2 blocks, each 128 query rows (two warpgroups) and one 192-column
// slice of O (96 accumulators a thread), summing the slices' partial scores
// through distributed shared memory; 64-key tiles; q's slice in shared memory
// (210 KB in all, one block an SM). Raced against, in one call on an H100 80GB
// HBM3 at 700 W (tools/bench_attention.py, bf16, both head dims' shapes edited
// alike in copies of the tree), at B=32, S=320 with the ragged mask / B=128,
// S=320: this shape 0.0914 / 0.2973 ms (second turn 0.0910 / 0.2953); q's slice
// in registers (48 a thread; at Dh 768 255 registers and a 4-byte spill) 0.0934
// / 0.3095 (0.0934 / 0.3095); 32-key tiles 0.1114 / 0.3700 (0.1115 / 0.3706);
// (b) no cluster, each block one warpgroup scoring over all of Dh from q in
// shared memory and full-width 32-key K tiles, 0.1248 / 0.3792 (0.1236 /
// 0.3765); SDPA 0.1190-0.1226 / 0.3500-0.3517; the FMA cluster kernel this
// replaced 0.4418 / 1.6978.
#define MMU_FWD_TC_DH 384
#include "attention_fwd_tc_wide.cuh"
