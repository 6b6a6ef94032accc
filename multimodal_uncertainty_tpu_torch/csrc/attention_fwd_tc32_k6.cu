// Split-fp32 attention forward instances at Dh 24, 48, 96 and 192
// (attention_fwd_tc32.cuh holds the kernels and their design notes). fp32
// only: bf16 runs on the bf16 tensor-core kernel, attention_fwd_tc_{24,48,k6,
// 192}.cu.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_pallas_fwd_impl
// (:160, pallas_call :167; "K6"): the heads-first forward the JAX package runs
// for FLAVA fusion at 32, 16, 8 and 4 heads of D=768. Here the heads-last rows
// are read in place; 24 and 48 pad the K-major rows of q and K to 32 / 64
// values, and their k-steps stop at Dh.
#define MMU_FWD_PLAIN_DIMS 24, 48, 96, 192
#define MMU_FWD_DROPOUT_DIMS
#include "attention_fwd_tc32.cuh"
