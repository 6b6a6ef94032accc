// Attention forward instances at Dh 384 and 768 (attention_fwd.cuh holds the
// kernel and its design notes).
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_fwd_impl
// (K1) and _sdpa_flash_fwd_impl (K3) at FLAVA fusion's 2 and 1 heads of
// D=768: the JAX package keeps Dh=384 at S=320 on the whole-sequence kernel
// and takes the resident flash kernels at S=736 and at Dh=768. One kernel
// covers both here. Shared memory a block: 157 KB at Dh=384 (64-key tiles);
// at Dh=768 a 64-key tile would need 304 KB of the 227 KB a block may have,
// so that instance streams 32-key tiles (one key a lane, 202 KB, one block an
// SM). A lane accumulates 4 rows x Dh/32 output columns: 48 fp32 registers at
// Dh=384, 96 at Dh=768.
#define MMU_FWD_PLAIN_DIMS 384, 768
#define MMU_FWD_DROPOUT_DIMS
#include "attention_fwd.cuh"
