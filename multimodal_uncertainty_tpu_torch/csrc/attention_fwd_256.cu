// Attention forward instance at Dh 256 in fp32 (attention_fwd_wide.cuh holds
// the kernel and its design notes): FLAVA fusion's default 3 heads of D=768,
// on its serving and training paths; one block of 64 query rows x 256
// columns, no cluster. bf16 runs on the tensor cores, attention_fwd_tc_256.cu.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_fwd_impl
// :777 (K1) and _sdpa_flash_fwd_impl :1071 (K3) at 3 heads of 256.
//
// Shapes measured on an H100 80GB HBM3 at 700 W (tools/bench_attention.py,
// B=32, S=320, fp32, each set in one call): R = 64 query rows 0.398 ms, R =
// 32 0.548 (twice the blocks, each re-streaming K and V); with R = 64, the
// products' 256 threads as 8 row groups x 32 chunk groups (8 x 8 floats a
// thread) 0.396, 16 x 16 (4 x 16) 0.401-0.405, 32 x 8 (2 x 32) 0.475. So
// Wide<256> in attention_fwd_wide.cuh is (N, C, R, GC) = (1, 256, 64, 32):
// 217 KB of shared memory, one block an SM.
#define MMU_FWD_PLAIN_DIMS 256
#include "attention_fwd_wide.cuh"
