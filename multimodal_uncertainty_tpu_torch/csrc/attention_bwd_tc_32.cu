// Attention backward in bf16 at Dh=32 on the tensor cores, without dropout
// and through it (attention_bwd_tc.cuh holds the kernels and their design
// notes): FLAVA fusion at 24 heads of D=768 under --bf16, and the tiny BERT's
// 2 heads of 32 (MMBT's --tiny), with its attention-probs dropout (K5).
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_bwd_impl
// :813 (K1, pallas_call :828) and _sdpa_flash_bwd_impl :1219 (K3, pallas_calls
// :1234, :1256) at 24 heads of 32, and, at the tiny BERT's Dh 32,
// _sdpa_hl_bwd_impl :504 (K2 bwd) and _sdpa_pallas_hl_drop_bwd :717 (K5 bwd,
// pallas_call :729, body _attn_bwd_kernel_hl_drop :595).
//
// A 64-byte row sits in one 64-column panel padded to 128 bytes: the K-major
// products (S = q k^T, dP = dO v^T and their transposes) are two whole k16
// steps, the MN-major ones (dQ, dK, dV) m64n32k16 inside the panel. Both
// passes keep their own rows' operands in registers (8 a thread each) and
// stream 64-row tiles, two blocks an SM, so that one block's exponentials run
// beside the other's products (P is rebuilt in both passes: 6.3e8
// exponentials at B=128, S=320, 24 heads), as at Dh 24. At the cap of 128
// registers the dK/dV pass spills 104 bytes and ptxas serialises its wgmma
// (C7512), the dQ pass 20; the dropout instances keep the shapes (208 / 32
// bytes). The keep mask is packed into bits as at Dh 64.
// Raced against, in one call on an H100 80GB HBM3 at 700 W
// (tools/bench_attention.py, from copies of the tree with the shapes edited),
// at B=128, S=320 / B=32, S=320 (ragged mask) / K5 at B=32, S=165 (24 heads,
// ragged, rate 0.1): this shape 0.9440 / 0.2687 / 0.2077 ms (0.9411 / 0.2688 /
// 0.2075 in its second turn); the dK/dV pass over 32-query tiles (no spills)
// 0.9732 / 0.2730 / 0.1885; the dQ pass over 32-key tiles 1.0093 / 0.2988 /
// 0.2157, both passes so 1.0367 / 0.3022 / 0.1961; one block an SM in both
// passes (no spills) 1.2269 / 0.3689 / 0.2254; SDPA's bf16 backward 0.9075-
// 0.9135 / 0.3060-0.6666 / 0.1786-1.6271 (with dropout_p; its readings
// spread); the FMA kernel this replaced 6.8345 / 1.7689 / 0.8260.
#define MMU_BWD_TC_DH 32
#define MMU_BWD_TC_DQ 64, 1, 2
#define MMU_BWD_TC_DKV 1, 64, 1, 2
#define MMU_BWD_TC_DROPOUT
#include "attention_bwd_tc.cuh"
