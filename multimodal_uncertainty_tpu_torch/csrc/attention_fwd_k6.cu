// Attention forward instances in bf16 at Dh 24, 48 and 192 (attention_fwd.cuh
// holds the kernel and its design notes); fp32 runs as split fp32 on the
// tensor cores, attention_fwd_tc32_k6.cu, and bf16 at Dh 96 on the bf16
// tensor-core kernel, attention_fwd_tc_k6.cu.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_pallas_fwd_impl
// (:160, pallas_call :167, body _attn_kernel :118; "K6"): the heads-first
// forward the JAX package runs for FLAVA fusion at 32, 16, 8 and 4 heads of
// D=768, whose head dims are neither a multiple nor a divisor of 128
// (_hl_block_width returns None). The TPU kernel takes (B, H, S, Dh) after a
// relayout of the packed projection and holds G heads' whole score planes in
// VMEM; here the same key-tiled kernel as every other head dim reads the
// heads-last rows in place, so the relayout goes. 24 and 48 are no multiple
// of 32: a lane owns ceil(Dh / 32) output columns over zeroed padding.
// Shared memory a block: 22 KB (Dh 24), 34 KB (48), 83 KB (192).
#define MMU_FWD_BF16_PLAIN_DIMS 24, 48, 192
#define MMU_FWD_BF16_DROPOUT_DIMS
#include "attention_fwd.cuh"
