// Attention backward instances at Dh 384 and 768 (attention_bwd.cuh holds the
// kernels and their design notes).
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_bwd_impl
// (K1) and _sdpa_flash_bwd_impl (K3) at FLAVA fusion's 2 and 1 heads of D=768.
// Dh=384 keeps 32-row tiles (dQ pass 203 KB, dK/dV pass 207 KB, one block an
// SM). At Dh=768 32-row tiles would take 403 KB, so a block owns 16 rows and
// streams 16-row tiles (199 / 200 KB); two lanes share each score, summing
// one half of Dh each. A lane accumulates dK and dV for 4 rows x 12 columns
// (Dh=384) or 2 rows x 24 columns (Dh=768): 96 fp32 registers either way.
#define MMU_BWD_PLAIN_DIMS 384, 768
#define MMU_BWD_DROPOUT_DIMS
#include "attention_bwd.cuh"
