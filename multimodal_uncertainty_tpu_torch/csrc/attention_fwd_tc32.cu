// Split-fp32 attention forward instances at Dh 32, 64 and 128, with dropout
// at 32 and 64 (attention_fwd_tc32.cuh holds the kernels and their design
// notes). fp32 only: bf16 runs on attention_fwd_tc{_32,,_128}.cu.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_fwd_impl
// (K1: FLAVA fusion at 12 and 6 heads of 64 and 128; ViLT at 12 of 64),
// _sdpa_flash_fwd_impl (K3), _sdpa_hl_fwd_impl (K2: BERT's 12 heads of 64; 2
// of 32 for the tiny config), _sdpa_hl_drop_fwd_impl (K5: BERT's
// attention-probs dropout) and _sdpa_flash_fwd_stream_impl (K4 in fp32).
#define MMU_FWD_PLAIN_DIMS 32, 64, 128
#define MMU_FWD_DROPOUT_DIMS 32, 64
#include "attention_fwd_tc32.cuh"
