// Attention forward in bf16 at Dh=64 on the tensor cores, without dropout
// and with it (attention_fwd_tc.cuh holds the kernel and its design notes):
// MMBT's, ViLT's and BERT's 12 heads of 64, K4, and BERT's attention-probs
// dropout under --bf16 (K5).
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's
// _sdpa_flash_fwd_stream_impl :1488 (K4), _sdpa_packed_fwd_impl :777 (K1),
// _sdpa_flash_fwd_impl :1071 (K3), _sdpa_hl_fwd_impl :419 (K2 fwd) and
// _sdpa_hl_drop_fwd_impl :677 (K5 fwd, pallas_call :689, body
// _attn_kernel_hl_drop :563) in bf16 at 64-wide heads.
//
// q stays in registers (16 a thread), O takes 32, S and P of a 64-key tile
// 32 and 16: two blocks an SM. Measured on an H100 80GB HBM3 at 700 W: 2.7
// ms at K4's B=1, S=16384, 12 x 64 (305 TFLOP/s of useful work;
// tools/bench_flash.py), 0.0285 ms at K2's B=32, S=165 against 0.0670 for
// SDPA (chip_smoke.py).
// The dropout instance keeps this shape (128 registers with 12 bytes of
// spills at two blocks an SM; the instance without dropout keeps its 128
// with none). Its keep mask is packed into row words by a launch of its own
// (see the header); raced in one call on the same card (B=32, 12 x 64, ragged
// mask, rate 0.1, S = 165 / 517, tools/bench_attention.py) against each
// thread loading the bytes of its accumulator elements, 32 a tile: packed
// 0.0551 / 0.2998 ms (0.0551 / 0.2996 in its second turn), the bytes 0.0660 /
// 0.4571 (0.0660 / 0.4567), without dropout 0.0277-0.0280 at S = 165; SDPA
// with dropout_p 0.0983-0.0991 / 0.5134-0.5142; the SIMT kernel this replaced
// 0.1830 at S = 165 (an earlier call).
#define MMU_FWD_TC_DH 64
#define MMU_FWD_TC_SHAPE 64, 1, 2
#define MMU_FWD_TC_DROPOUT
#include "attention_fwd_tc.cuh"
