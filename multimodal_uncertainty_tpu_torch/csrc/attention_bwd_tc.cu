// Attention backward in bf16 at Dh=64, without dropout, on the tensor cores
// (attention_bwd_tc.cuh holds the kernels and their design notes): MMBT's,
// ViLT's and BERT's 12 heads of 64, and K4.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's
// _sdpa_flash_bwd_stream_impl :1521 (K4), _sdpa_packed_bwd_impl :813 (K1),
// _sdpa_flash_bwd_impl :1219 (K3) and _sdpa_hl_bwd_impl :504 (K2 bwd) in
// bf16 at 64-wide heads.
//
// Both passes keep their own rows' two operands in registers (16 a thread
// each) and stream 64-row tiles: dQ and dK, dV take 32 fp32 registers a
// thread each, S and dP 32 each. Measured on an H100 80GB HBM3 at 700 W
// (tools/bench_attention.py, B=32, S=165, ragged key mask): 0.1144-0.1147 ms,
// 0.1169-0.1171 with the one-thread-a-(row, head) delta pass it had before,
// against 0.0975 for SDPA's bf16 backward.
#define MMU_BWD_TC_DH 64
#define MMU_BWD_TC_DQ 64, 1, 1
#define MMU_BWD_TC_DKV 1, 64, 1, 1
#include "attention_bwd_tc.cuh"
