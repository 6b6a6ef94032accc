// bf16 attention forward instances at Dh 32 and 128, and the dropout instance
// at Dh 32, the tiny BERT's (attention_fwd.cuh holds the kernel and its
// design notes). fp32 at Dh 32, 64 and 128, with and without dropout, runs as
// split fp32 on the tensor cores, attention_fwd_tc32.cu; bf16 at Dh=64, with
// and without dropout, on attention_fwd_tc.cu; Dh=256 on attention_fwd_256.cu
// (fp32) and attention_fwd_tc_256.cu (bf16).
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_fwd_impl
// (K1: FLAVA fusion at 6 heads of 128, 12 of 64; ViLT at 12 of 64),
// _sdpa_flash_fwd_impl (K3: the same past the TPU's whole-sequence budget),
// _sdpa_hl_fwd_impl (K2: BERT's 12 heads of 64; 2 of 32 for the tiny config)
// and _sdpa_hl_drop_fwd_impl (K5: BERT's attention-probs dropout).
#define MMU_FWD_BF16_PLAIN_DIMS 32, 128
#define MMU_FWD_BF16_DROPOUT_DIMS 32
#include "attention_fwd.cuh"
