// Attention backward instances in fp32 at Dh 32, 64 and 128, and the dropout
// instances at Dh 32 and 64 (attention_bwd_wide.cuh holds the kernel and its
// design notes: one block of R rows x Dh columns, no cluster). bf16 is not
// here, with or without dropout: it runs on the tensor cores,
// attention_bwd_tc{,_32,_128}.cu; nor is Dh=256: attention_bwd_256.cu.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_bwd_impl
// (K1: FLAVA fusion, ViLT), _sdpa_flash_bwd_impl (K3: the same past the TPU's
// whole-sequence budget), _sdpa_hl_bwd_impl (K2: BERT's 12 heads of 64; 2 of
// 32 for the tiny config), _sdpa_pallas_hl_drop_bwd (K5: BERT's
// attention-probs dropout) and, in fp32, _sdpa_flash_bwd_stream_impl (K4 at
// Dh=64, through attention_flash).
#define MMU_BWD_PLAIN_DIMS 32, 64, 128
#define MMU_BWD_DROPOUT_DIMS 32, 64
#include "attention_bwd_wide.cuh"
