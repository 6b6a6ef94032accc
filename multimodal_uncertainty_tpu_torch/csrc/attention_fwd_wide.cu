// Attention forward instances at Dh 384 and 768 in fp32 (attention_fwd_wide.cuh
// holds the kernel and its design notes): clusters of 2 and 4 blocks, each a
// 192-column slice of 64 query rows. bf16 runs on the tensor cores,
// attention_fwd_tc_384.cu and attention_fwd_tc_768.cu.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_fwd_impl
// :777 (K1) and _sdpa_flash_fwd_impl :1071 (K3) at FLAVA fusion's 2 and 1
// heads of D=768.
#define MMU_FWD_PLAIN_DIMS 384, 768
#include "attention_fwd_wide.cuh"
