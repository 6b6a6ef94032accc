// Attention backward instance at Dh 256 in fp32 (attention_bwd_wide.cuh holds
// the kernel and its design notes): FLAVA fusion's default 3 heads of D=768,
// on its training path. bf16 runs on the tensor cores, attention_bwd_tc_256.cu.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_bwd_impl
// :813 (K1) and _sdpa_flash_bwd_impl :1219 (K3) at 3 heads of 256.
//
// Two shapes of the template fit the 255 registers of a thread at this head
// dim, 64 accumulators each: (a) clusters of 2 blocks of 64 rows x 128
// columns (the cluster kernel of Dh 384 / 768 at a narrower slice), and (b)
// one block of 32 rows x 256 columns with no cluster barrier and no remote
// traffic. One block of 64 rows x 256 columns would need 128 accumulators a
// thread. Measured on an H100 80GB HBM3 at 700 W (tools/bench_attention.py,
// B=128, S=320, fp32): (b) 5.04 ms, (a) 5.18-5.24 ms, so Wide<256> in
// attention_bwd_wide.cuh is (b).
#define MMU_BWD_PLAIN_DIMS 256
#include "attention_bwd_wide.cuh"
