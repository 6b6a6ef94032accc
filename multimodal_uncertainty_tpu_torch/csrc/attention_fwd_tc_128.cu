// Attention forward in bf16 at Dh=128, without dropout, on the tensor cores
// (attention_fwd_tc.cuh holds the kernel and its design notes): FLAVA fusion
// at 6 heads of D=768 under --bf16.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_fwd_impl
// :777 (K1, pallas_call :788, body _attn_kernel_hl :348) and
// _sdpa_flash_fwd_impl :1071 (K3, pallas_call :1087, body
// _attn_kernel_flash_fwd :1000) at 6 heads of 128, which the TPU runs one
// head a 128-lane block (_hl_block_width).
//
// A 256-byte row is two whole 64-column panels: S = q k^T takes 8 k16 steps,
// 4 a panel, and O += P v is one m64n128k16 a step across both panels by the
// leading-byte offset. O of 64 rows x 128 takes 64 fp32 registers a thread,
// q as A fragments 32 more and S and P of a 64-key tile 32 + 16: 144 before
// addressing, more than the 128 of two blocks an SM. So q sits in shared
// memory (32 KB for 128 rows) beside a two-stage ring of 64-key K / V tiles
// (64 KB), as at Dh 192 and 256, and two blocks fit an SM (128 registers, no
// spills). Raced against, in one call on an H100 80GB HBM3 at 700 W
// (tools/bench_attention.py, bf16, from copies of the tree with this define
// edited), at B=128, S=320 / B=32, S=320 (ragged mask): this shape 0.1627 /
// 0.0574 ms (0.1617 / 0.0570 in its second turn); q in shared memory over
// 32-key tiles, two blocks an SM 0.1913 / 0.0690; q in registers, one block
// an SM (194 registers) 0.2141 / 0.0701; q in registers, two blocks an SM
// (240 bytes of spills, wgmma serialised: C7512) 0.2267 / 0.0777; q in
// registers over 32-key tiles, two blocks an SM (120 bytes of spills, C7512)
// 0.2415 / 0.0842; SDPA 0.1207-0.1267 / 0.0544-0.0551; the SIMT kernel this
// replaced 1.5576 / 0.4118.
#define MMU_FWD_TC_DH 128
#define MMU_FWD_TC_SHAPE 64, 0, 2
#include "attention_fwd_tc.cuh"
