// Attention backward in bf16 at Dh=384, without dropout, on the tensor cores
// and clusters of 2 blocks (attention_bwd_tc_wide.cuh holds the kernels and
// their design notes): FLAVA fusion at 2 heads of D=768 under --bf16.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_bwd_impl
// :813 (K1, pallas_call :828, body _attn_bwd_kernel_hl :443) and
// _sdpa_flash_bwd_impl :1219 (K3, pallas_calls :1234, :1256) at 2 heads of
// 384.
//
// Its cluster of 2 blocks sums the partials by the all-read (dK/dV pass 230
// registers, dQ pass 204, no spills). Raced in one call on an H100 80GB HBM3
// at 700 W (tools/bench_attention.py, bf16, B=128 at S = 320 / 736, from
// copies of the tree with BwdTcWide's choice edited): the all-read 1.1170 /
// 5.3160 ms (1.1169 / 5.3186 in its second turn), the reduce-scatter 1.1440 /
// 5.5171 (1.1445 / 5.4814); SDPA's bf16 backward 2.6645-2.6668 /
// 11.2054-11.2471; the plain version 5.4556 at S = 320. The FMA cluster
// kernel this replaced took 5.0008 at S = 320 (an earlier call of the same
// tool).
#define MMU_BWD_TC_DH 384
#include "attention_bwd_tc_wide.cuh"
