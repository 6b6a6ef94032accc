// Attention backward instances at Dh 384 and 768 in fp32 (attention_bwd_wide.cuh
// holds the kernel and its design notes): clusters of 2 and 4 blocks, each a
// 192-column slice of 64 rows, 96 accumulators a thread. bf16 runs on the
// tensor-core clusters of attention_bwd_tc_{384,768}.cu.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_bwd_impl
// :813 (K1) and _sdpa_flash_bwd_impl :1219 (K3) in fp32 at FLAVA fusion's 2
// and 1 heads of D=768.
#define MMU_BWD_PLAIN_DIMS 384, 768
#include "attention_bwd_wide.cuh"
