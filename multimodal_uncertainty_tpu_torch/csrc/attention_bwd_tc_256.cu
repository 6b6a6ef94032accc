// Attention backward in bf16 at Dh=256, without dropout, on the tensor cores
// (attention_bwd_tc.cuh holds the kernels and their design notes): FLAVA
// fusion's default 3 heads of D=768 under --bf16, on its training path.
//
// Replaces multimodal_uncertainty_tpu/ops/attention.py's _sdpa_packed_bwd_impl
// :813 (K1, pallas_call :828) and _sdpa_flash_bwd_impl :1219 (K3, pallas_calls
// :1234, :1256) at 3 heads of 256.
//
// The register plan of Dh 64 does not fit: q and dO (or k and v) as A
// fragments would take 64 + 64 registers a thread, and 64 rows x 256 of dK
// and dV 128 + 128. So the own rows' operands stay in shared memory (wgmma
// reads A from there). The dQ pass runs 128 query rows a block, 64 a
// warpgroup with all 256 columns of dQ (128 registers; 207 in all), over
// 32-key tiles (q, dO 128 KB + ring 64 KB). In the dK/dV pass the two
// warpgroups own the same 64 keys, 128 columns each of dK and dV (64 + 64
// registers), and split each 64-query tile's S^T and dP^T between them,
// handing P and dS over through shared memory (k, v 64 KB + ring 128 KB +
// 16 KB; 218 registers).
// Raced against, in one call on an H100 80GB HBM3 at 700 W
// (tools/bench_attention.py, B=128 at S = 320 / 736), and removed: (a) the
// dK/dV pass without the exchange, each warpgroup computing the full S^T and
// dP^T; (b) the first design, dQ on column halves too (64 rows a block,
// 64-key tiles, S and dP recomputed by both warpgroups) and dK/dV on 32-query
// tiles; (c) the exchange in the dQ pass too, on column halves. This shape
// 0.6689-0.6730 / 2.6685-2.6885 ms, (a) 0.7004 / 2.8308, (b) 0.8445 /
// 3.6823, (c) 0.6885 / 2.9179; SDPA's bf16 backward 0.6250-0.6318 /
// 2.2595-2.2860; the FMA kernel this replaced 5.3592-5.3991 /
// 26.6947-26.8238.
#define MMU_BWD_TC_DH 256
#define MMU_BWD_TC_DQ 32, 0, 1
#define MMU_BWD_TC_DKV 2, 64, 0, 1
#include "attention_bwd_tc.cuh"
