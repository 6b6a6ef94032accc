// Attention backward instances in fp32 at Dh 24, 48, 96 and 192
// (attention_bwd_wide.cuh holds the kernel and its design notes: one block of
// R rows x Dh columns, no cluster; 24 and 48 are no multiple of 32, so their
// shared-memory rows are padded by one 16-byte chunk). bf16 is not here: it
// runs on the tensor cores, attention_bwd_tc_{24,48,k6,192}.cu.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_bwd_impl (:253,
// pallas_call :261, body _attn_bwd_kernel :198; "K6"), the backward of the
// custom VJP _sdpa_pallas (:189) that the JAX package runs when FLAVA fusion
// trains at 32, 16, 8 or 4 heads of D=768. The TPU kernel recomputes the
// softmax over G heads' whole (S, S) planes in VMEM; here the same three
// passes as every other head dim (delta, dQ, dK/dV) rebuild P from the
// forward's LSE, reading heads-last rows in place.
#define MMU_BWD_PLAIN_DIMS 24, 48, 96, 192
#include "attention_bwd_wide.cuh"
