// Attention backward in bf16 at Dh=768, without dropout, on the tensor cores
// and clusters of 4 blocks (attention_bwd_tc_wide.cuh holds the kernels and
// their design notes): FLAVA fusion at 1 head of D=768 under --bf16.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_bwd_impl
// :813 (K1, pallas_call :828, body _attn_bwd_kernel_hl :443) and
// _sdpa_flash_bwd_impl :1219 (K3, pallas_calls :1234, :1256) at 1 head of
// 768.
//
// Its cluster of 4 blocks sums the partials by the reduce-scatter (dK/dV pass
// 194 registers, dQ pass 192, no spills): there the all-read moves 128 KB of
// partials a tile a block. Raced in one call on an H100 80GB HBM3 at 700 W
// (tools/bench_attention.py, bf16, B=128 at S = 320 / 736, from copies of the
// tree with BwdTcWide's choice edited): the reduce-scatter 1.3588 / 6.5739 ms
// (1.3626 / 6.5911 in its second turn), the all-read 1.7280 / 8.7393 (1.7213
// / 8.6658; 255 registers in both passes); SDPA's bf16 backward
// 2.7398-2.7442 / 11.4945-11.5077; the plain version 3.7912 at S = 320. The
// FMA cluster kernel this replaced took 5.6437 at S = 320 (an earlier call
// of the same tool).
#define MMU_BWD_TC_DH 768
#include "attention_bwd_tc_wide.cuh"
