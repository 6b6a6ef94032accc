// Attention forward in bf16 at Dh=32 on the tensor cores, without dropout
// and with it (attention_fwd_tc.cuh holds the kernel and its design notes):
// FLAVA fusion at 24 heads of D=768 under --bf16, and the tiny BERT's 2 heads
// of 32 (MMBT's --tiny), with its attention-probs dropout (K5).
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_fwd_impl
// :777 (K1, pallas_call :788, body _attn_kernel_hl :348) and
// _sdpa_flash_fwd_impl :1071 (K3, pallas_call :1087) at 24 heads of 32, which
// the TPU runs four heads a 128-lane block (_hl_block_width), and, at the tiny
// BERT's Dh 32, _sdpa_hl_fwd_impl :419 (K2 fwd) and _sdpa_hl_drop_fwd_impl
// :677 (K5 fwd, pallas_call :689, body _attn_kernel_hl_drop :563).
//
// A 64-byte row sits in one 64-column panel padded to 128 bytes: S = q k^T is
// two whole k16 steps, O += P v one m64n32k16 a step inside the panel; nothing
// reads the padding and, unlike Dh 24, no lane needs zeroing. q in registers
// (8 a thread), O 16, S and P of a 64-key tile 32 and 16. At 24 heads the
// exponentials set the pace, not the products (B H S^2 of them, 3.1e8 at
// B=128, S=320, about 0.085 ms at the SFU's 16 a clock per SM), so three
// blocks an SM let one block's softmax run beside the others' products: 80
// registers, where ptxas spills 32 bytes and serialises the wgmma (C7512), and
// it still ran ahead of two blocks an SM with no spills. The dropout instance
// keeps the shape; its keep mask is packed into row words as at Dh 64.
// Raced against, in one call on an H100 80GB HBM3 at 700 W
// (tools/bench_attention.py, bf16, from copies of the tree with this define
// edited), at B=128, S=320 / B=32, S=320 (ragged mask) / K5 at B=32, S=165
// (24 heads, ragged, rate 0.1): this shape 0.2785 / 0.0827 / 0.0815 ms
// (0.2773 / 0.0823 / 0.0817 in its second turn); 64-key tiles, two blocks an
// SM (Dh 24's shape; 105 registers, no spills) 0.2914 / 0.0881 / 0.0820; one
// block an SM 0.2907 / 0.0883 / 0.0822; 32-key tiles, two or three blocks
// an SM 0.3117 / 0.0956 / 0.0880 and 0.3116 / 0.0951 / 0.0879; SDPA 0.3297-
// 0.3418 / 0.1356-0.1366 / 0.1881-0.1893; the SIMT kernel this replaced
// 2.1698 / 0.5592 / 0.2168.
#define MMU_FWD_TC_DH 32
#define MMU_FWD_TC_SHAPE 64, 1, 3
#define MMU_FWD_TC_DROPOUT
#include "attention_fwd_tc.cuh"
