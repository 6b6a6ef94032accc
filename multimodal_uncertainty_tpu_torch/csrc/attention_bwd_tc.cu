// Attention backward in bf16 at Dh=64 on the tensor cores, without dropout
// and with it (attention_bwd_tc.cuh holds the kernels and their design
// notes): MMBT's, ViLT's and BERT's 12 heads of 64, K4, and BERT's
// attention-probs dropout under --bf16 (K5).
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's
// _sdpa_flash_bwd_stream_impl :1521 (K4), _sdpa_packed_bwd_impl :813 (K1),
// _sdpa_flash_bwd_impl :1219 (K3), _sdpa_hl_bwd_impl :504 (K2 bwd) and
// _sdpa_pallas_hl_drop_bwd :717 (K5 bwd, pallas_call :729) in bf16 at
// 64-wide heads.
//
// Both passes keep their own rows' two operands in registers (16 a thread
// each) and stream 64-row tiles: dQ and dK, dV take 32 fp32 registers a
// thread each, S and dP 32 each. Measured on an H100 80GB HBM3 at 700 W
// (tools/bench_attention.py, B=32, S=165, ragged key mask): 0.1144-0.1147 ms,
// 0.1169-0.1171 with the one-thread-a-(row, head) delta pass it had before,
// against 0.0975 for SDPA's bf16 backward.
// The dropout instances keep these shapes (dK/dV 254 registers, dQ 200, no
// spills). Their keep mask is packed into bits by a pass of its own (see the
// header); raced in one call on the same card (B=32, 12 x 64, ragged mask,
// rate 0.1, S = 165 / 517) against each thread loading the bytes of its
// accumulator elements (32 a tile a pass, transposed in the dK/dV pass):
// packed 0.1510 / 0.8039 ms (0.1510 / 0.8038 in its second turn), the bytes
// 0.3030 / 2.0744 (0.3026 / 2.0745), the packed design with its per-tile
// loads replaced by constant bits 0.1444 / 0.7443, without dropout 0.1155 /
// 0.5926; SDPA's bf16 backward with dropout_p 0.1073 / 0.5363 (its fastest
// readings); the FMA kernel this replaced 0.6077 / 4.6972 (an earlier call).
#define MMU_BWD_TC_DH 64
#define MMU_BWD_TC_DQ 64, 1, 1
#define MMU_BWD_TC_DKV 1, 64, 1, 1
#define MMU_BWD_TC_DROPOUT
#include "attention_bwd_tc.cuh"
