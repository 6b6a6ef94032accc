// Attention forward in bf16 at Dh=64, without dropout, on the tensor cores
// (attention_fwd_tc.cuh holds the kernel and its design notes): MMBT's,
// ViLT's and BERT's 12 heads of 64, and K4.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's
// _sdpa_flash_fwd_stream_impl :1488 (K4), _sdpa_packed_fwd_impl :777 (K1),
// _sdpa_flash_fwd_impl :1071 (K3) and _sdpa_hl_fwd_impl :419 (K2 fwd) in
// bf16 at 64-wide heads.
//
// q stays in registers (16 a thread), O takes 32, S and P of a 64-key tile
// 32 and 16: two blocks an SM. Measured on an H100 80GB HBM3 at 700 W: 2.7
// ms at K4's B=1, S=16384, 12 x 64 (305 TFLOP/s of useful work;
// tools/bench_flash.py), 0.0285 ms at K2's B=32, S=165 against 0.0670 for
// SDPA (chip_smoke.py).
#define MMU_FWD_TC_DH 64
#define MMU_FWD_TC_SHAPE 64, 1, 2
#include "attention_fwd_tc.cuh"
