// Attention forward in bf16 at Dh=256, without dropout, on the tensor cores
// (attention_fwd_tc.cuh holds the kernel and its design notes): FLAVA
// fusion's default 3 heads of D=768 under --bf16, on its training path.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_fwd_impl
// :777 (K1, pallas_call :788, body _attn_kernel_hl :348) and
// _sdpa_flash_fwd_impl :1071 (K3, pallas_call :1087, body
// _attn_kernel_flash_fwd :1000) at 3 heads of 256.
//
// O of 64 rows x 256 columns takes 128 fp32 registers a thread of a
// warpgroup, and q as A fragments would take 64 more. So q sits in shared
// memory (wgmma reads A from there): each warpgroup owns 64 query rows and
// all 256 columns of O, 128 rows a block (q 64 KB), over 64-key tiles in a
// two-stage ring (128 KB), one block an SM (225 registers, no spills). At S
// = 320 the last row block's second warpgroup has no rows and skips its
// products. Raced against, in one call on an H100 80GB HBM3 at 700 W
// (tools/bench_attention.py, bf16, B=128 at S = 320 / 736, and B=32, S=320
// with a ragged mask; from copies of the tree with the shape edited), and
// removed with its code: (b) columns, both warpgroups owning the same 64
// rows and 128 columns each of O (64 registers), each computing the full S
// (161 registers; q 32 KB). This shape 0.1720 / 0.7130 / 0.0652 ms (0.1717
// / 0.7133 / 0.0650 in its second turn), (b) 0.2376 / 1.1204 / 0.0805, this
// shape over 32-key tiles 0.2066 / 0.8549 / 0.0794; SDPA 0.1198 / 0.3833 /
// 0.0885. In a second call, against (c) blocks of one warpgroup (64 query
// rows, q 32 KB) over 32-key tiles, two an SM (203 registers), removed with
// its code: this shape 0.1716 / 0.7123 / 0.0645 (0.1702 / 0.7070 / 0.0645),
// (c) 0.2094 / 0.9135 / 0.0650 (0.2077 / 0.9066 / 0.0654); SDPA 0.1207 /
// 0.3875 / 0.0880. What holds it back at S = 736 (0.71 ms against 0.22 ms of
// flops at the tensor rate): both warpgroups of the one block an SM wait at
// every tile's two barriers, so one's softmax does not overlap the other's
// products, and each 128-row block streams all of K and V from L2.
#define MMU_FWD_TC_DH 256
#define MMU_FWD_TC_SHAPE 64, 0, 1
#include "attention_fwd_tc.cuh"
