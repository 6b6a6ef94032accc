"""The port's weight-gradient route (``ops/dw.py``) against the JAX package's, on the CPU.

``dw_plain`` is held to the JAX Pallas kernel ``_dw_pallas_2d`` run in
interpret mode, and the port's autograd Function (``linear_dw``) to the VJP
of JAX's ``dot_general_dw(..., interpret=True)``, at K = 512 (one kernel
block), 300 (the JAX kernel's zero-row padding path) and 32 (the pooler's
K = B), on the same numpy inputs. On the CPU the Function takes
``dw_plain``; the CUDA kernel runs only on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances: fp32 within 1e-4 x max(1, max|ref|) (sums of K products in
another order); bf16 inputs within 1e-2 x max(1, max|ref|) where the
gradient returned is itself bf16 (one rounding), the fp32 dW within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.ops import dw as jdw
from multimodal_uncertainty_tpu_torch.models.layers import Linear, set_fast_dw
from multimodal_uncertainty_tpu_torch.ops import dw

DIN, DOUT = 256, 384


def _tol(ref, rel):
    return rel * max(1.0, float(np.abs(np.asarray(ref, np.float32)).max()))


@pytest.mark.parametrize("k", [512, 300, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dw_plain_matches_the_jax_kernel_in_interpret_mode(k, dtype):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(k, DIN)).astype(np.float32)
    dy = rng.normal(size=(k, DOUT)).astype(np.float32)
    jx, jdy = jnp.asarray(x).astype(dtype), jnp.asarray(dy).astype(dtype)
    ref = np.asarray(jdw._dw_pallas_2d(jx, jdy, interpret=True))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    tdy = torch.from_numpy(np.array(jdy.astype(jnp.float32))).to(getattr(torch, dtype))
    got = dw.dw_plain(tx, tdy)  # torch's (Dout, Din) layout; JAX's kernel gives (Din, Dout)
    assert got.dtype == torch.float32 and got.shape == (DOUT, DIN)
    np.testing.assert_allclose(got.numpy(), ref.T, atol=_tol(ref, 1e-4), rtol=0)
    np.testing.assert_allclose(dw.weight_grad(tx, tdy).numpy(), ref.T, atol=_tol(ref, 1e-4),
                               rtol=0)  # the CPU route


@pytest.mark.parametrize("k", [512, 300, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_dw_gradients_match_jax_dot_general_dw(k, dtype):
    """y = x @ W with W (Din, Dout) in JAX, (Dout, Din) in the port; the
    gradients of sum(y * g) through both custom VJPs."""
    rng = np.random.default_rng(k + 1)
    b = 4 if k % 4 == 0 else 3
    x = rng.normal(size=(b, k // b, DIN)).astype(np.float32)
    w = (rng.normal(size=(DIN, DOUT)) / np.sqrt(DIN)).astype(np.float32)
    g = rng.normal(size=(b, k // b, DOUT)).astype(np.float32)
    jx, jw, jg = (jnp.asarray(a).astype(dtype) for a in (x, w, g))
    y, vjp = jax.vjp(lambda a, c: jdw.dot_general_dw(a, c, True), jx, jw)
    ref_dx, ref_dw = vjp(jg)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt).requires_grad_()
    tw = torch.from_numpy(np.asarray(jw.astype(jnp.float32)).T.copy()).to(tdt).requires_grad_()
    out = dw.linear_dw(tx, tw)
    out.backward(torch.from_numpy(np.array(jg.astype(jnp.float32))).to(tdt))
    rel = 1e-4 if dtype == "float32" else 1e-2
    for got, ref in ((out, y), (tx.grad, ref_dx), (tw.grad.t(), ref_dw)):
        assert got.dtype == tdt
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(got.detach().float().numpy(), ref, atol=_tol(ref, rel),
                                   rtol=0)


def test_strided_input_takes_the_route_in_place():
    """The pooler's x[:, 0] (a strided view) gives the gradient of a dense copy."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(8, 5, 128)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(128, 128)).astype(np.float32)).requires_grad_()
    dw.linear_dw(x[:, 0], w).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), dw.dw_plain(x[:, 0].contiguous(),
                                                           torch.ones(8, 128)).numpy(),
                               atol=1e-5)


def test_the_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        dw.dw_cuda(torch.zeros(8, 128), torch.zeros(8, 128))


@pytest.mark.parametrize("k,din,dout,splits", [
    (5920, 768, 768, 7), (5920, 768, 3072, 5), (5920, 768, 2304, 2), (5920, 3072, 768, 5),
    (32, 768, 768, 1), (300, 128, 256, 5), (1001, 384, 640, 8), (0, 128, 128, 1),
])
def test_k_splits_cover_every_row_once(k, din, dout, splits):
    """The fp32 split-fp32 kernel's split on 132 SMs (the wave model at a
    third of the TF32 rate): the chunks are multiples of its 32-row stage,
    cover K, and none is empty."""
    got, chunk = dw.k_splits(k, din, dout, 132)
    assert got == splits and chunk % 32 == 0
    assert got * chunk >= k and (got - 1) * chunk < max(k, 1)


SMS = 132  # an H100 SXM's


@pytest.mark.parametrize("k,din,dout,grid", [
    (70144, 768, 3072, SMS), (70144 + 13, 768, 3072, SMS), (5920, 768, 3072, SMS),
    (5920, 768, 768, 126), (5920, 768, 2304, 108), (5920, 3072, 768, SMS),
    (32, 768, 768, 18), (1001, 384, 640, 130), (0, 128, 128, 1),
])
def test_stream_k_plan_covers_every_stage_once(k, din, dout, grid):
    """The bf16 kernel's plan on 132 SMs: G <= SMs blocks (stream-K, or a
    multiple of the tiles where its longest share is within
    ``ALIGNED_SLACK`` of stream-K's: 768 x 768 and 768 x 2304 here) whose
    shares of the (tile, 64-row stage) iterations differ by one at most and
    cover each exactly once, each block's tiles from the top of its range
    down; each block leaves at most one partial; in a stream-K grid it is
    the block's first work, each tile is finished by the block holding its
    last stage, as that block's last work, after the partials of exactly the
    lower blocks that hold its earlier stages; in an aligned grid every
    block lies in one tile and the slices of a tile's blocks cover it once;
    the workspace is one 128 x 256 fp32 tile a block."""
    plan = dw.stream_k_plan(k, din, dout, SMS)
    assert plan.grid == grid <= SMS
    assert plan.tiles == (dout // 128) * -(-din // 256)
    assert plan.stages == -(-max(k, 1) // dw.STREAM_STAGE) and dw.STREAM_STAGE == 64
    assert plan.workspace == grid * 128 * 256
    assert plan.aligned == (grid % plan.tiles == 0)
    shares = [hi - lo for lo, hi in map(plan.block_range, range(grid))]
    assert max(shares) - min(shares) <= 1 and min(shares) >= 1
    seen = {}
    for b in range(grid):
        segs = plan.segments(b)
        lo, hi = plan.block_range(b)
        assert sum(s1 - s0 for _, s0, s1, _ in segs) == hi - lo
        assert [t for t, *_ in segs] == sorted({t for t, *_ in segs}, reverse=True)
        assert not plan.aligned or len(segs) == 1
        assert [kind for *_, kind in segs].count("partial") <= 1
        for i, (tile, s0, s1, kind) in enumerate(segs):
            assert 0 <= s0 < s1 <= plan.stages
            assert (kind == "whole") == (s0 == 0 and s1 == plan.stages)
            assert kind != "partial" or i == 0  # a block's one partial is its first work
            assert kind != "finish" or i == len(segs) - 1 and not plan.aligned
            for s in range(s0, s1):
                assert (tile, s) not in seen
                seen[(tile, s)] = (b, kind)
    assert len(seen) == plan.iters
    for tile in range(plan.tiles):
        holders = sorted({b for (t, _), (b, _) in seen.items() if t == tile})
        assert plan.contributors(tile) == holders == list(range(holders[0], holders[-1] + 1))
        owner, kind = seen[(tile, plan.stages - 1)]
        if len(holders) == 1:
            assert kind == "whole"
        elif plan.aligned:
            parts = [plan.slice(b, tile) for b in holders]
            assert parts[0][0] == 0 and parts[-1][1] == 128 * 256 // 4
            assert all(p[1] == q[0] for p, q in zip(parts, parts[1:]))
        else:
            assert kind == "finish" and owner == holders[-1]
            assert plan.waits(owner, tile) == holders[-2::-1]
            assert all(plan.segments(p)[0][0] == tile and plan.segments(p)[0][3] == "partial"
                       for p in holders[:-1])


def _stream_k_emulated(x, dy, sms):
    """``dw_kernel_tc``'s sums emulated on the CPU: each block sums its
    segments' 64-row stages in fp32, in order, into a 128 x 256 tile (bf16
    products are exact in fp32); a whole tile is stored, a partial goes to
    the block's slot; a stream-K finish adds the slots of ``plan.waits`` in
    their order; an aligned grid's tile is summed slice by slice over its
    blocks' slots in block order (float4 j of thread t at j * 256 + t).
    Returns (Dout, Din) fp32 and the plan."""
    k, din = x.shape
    dout = dy.shape[1]
    plan = dw.stream_k_plan(k, din, dout, sms)
    (bm, bn), st = dw.STREAM_TILE, dw.STREAM_STAGE
    n_i = -(-din // bn)
    xf = torch.nn.functional.pad(x.float(), (0, n_i * bn - din))
    dyf = dy.float()
    out = torch.full((dout, n_i * bn), float("nan"))
    # the accumulators' order: float4 j of thread t holds rows r, r + 8, columns 8 j + 2 (t % 4)
    # and + 1, with r = 64 (t // 128) + 16 ((t % 128) // 32) + (t % 32) // 4
    t = torch.arange(256)
    r = 64 * (t // 128) + 16 * ((t % 128) // 32) + (t % 32) // 4
    rows = torch.stack([r, r, r + 8, r + 8], 1)[None].expand(32, 256, 4)
    cols = (8 * torch.arange(32)[:, None, None] + 2 * (t % 4)[None, :, None]
            + torch.tensor([0, 1, 0, 1])[None, None, :])
    def tile_of(flat):  # (8192, 4) in the accumulators' order -> the 128 x 256 tile
        tile = torch.empty(bm, bn)
        tile[rows.reshape(-1), cols.reshape(-1)] = flat.reshape(-1)
        return tile

    slots = {}
    for b in range(plan.grid):  # block by block: every partial comes before its use
        for tile, s0, s1, kind in plan.segments(b):
            o0, i0 = (tile // n_i) * bm, (tile % n_i) * bn
            acc = torch.zeros(bm, bn)
            for s in range(s0, s1):
                ks = slice(s * st, (s + 1) * st)
                acc += dyf[ks, o0:o0 + bm].t() @ xf[ks, i0:i0 + bn]
            if kind == "partial":
                slots[b] = acc[rows, cols].reshape(-1, 4)
                continue
            for p in plan.waits(b, tile) if kind == "finish" else ():
                acc += tile_of(slots[p])
            out[o0:o0 + bm, i0:i0 + bn] = acc
    for tile in range(plan.tiles) if plan.aligned else ():
        who = plan.contributors(tile)
        if len(who) == 1:
            continue
        o0, i0 = (tile // n_i) * bm, (tile % n_i) * bn
        flat = torch.empty(bm * bn // 4, 4)
        for b in who:
            f0, f1 = plan.slice(b, tile)
            part = torch.zeros(f1 - f0, 4)
            for p in who:
                part += slots[p][f0:f1]
            flat[f0:f1] = part
        out[o0:o0 + bm, i0:i0 + bn] = tile_of(flat)
    return out[:, :din], plan


@pytest.mark.parametrize("sms,aligned", [(5, False), (7, True)])
def test_stream_k_sums_match_the_jax_kernel_in_interpret_mode(sms, aligned):
    """The plan's partial sums, emulated in fp32 in the kernel's order at a
    small ragged shape where tiles span blocks (K = 300: five 64-row stages,
    the last ragged; 256 x 384: three tiles; 5 "SMs": stream-K, 7: an
    aligned grid of 6), against ``dw_plain`` and the JAX ``_dw_pallas_2d`` in
    interpret mode on the same bf16 inputs, 1e-4 x max(1, max|ref|): fp32
    sums in another order."""
    rng = np.random.default_rng(sms)
    jx = jnp.asarray(rng.normal(size=(300, DIN)).astype(np.float32)).astype(jnp.bfloat16)
    jdy = jnp.asarray(rng.normal(size=(300, DOUT)).astype(np.float32)).astype(jnp.bfloat16)
    ref = np.asarray(jdw._dw_pallas_2d(jx, jdy, interpret=True)).T
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    tdy = torch.from_numpy(np.array(jdy.astype(jnp.float32))).bfloat16()
    got, plan = _stream_k_emulated(tx, tdy, sms)
    assert plan.aligned == aligned
    assert all(len(plan.contributors(t)) > 1 for t in range(plan.tiles))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), ref, atol=_tol(ref, 1e-4), rtol=0)
    np.testing.assert_allclose(got.numpy(), dw.dw_plain(tx, tdy).numpy(), atol=_tol(ref, 1e-4),
                               rtol=0)


@pytest.mark.parametrize("k,dtype,route", [
    (1, torch.float32, "simt"), (32, torch.float32, "simt"), (64, torch.float32, "simt"),
    (128, torch.float32, "simt"), (129, torch.float32, "tc32"), (5920, torch.float32, "tc32"),
    (1, torch.bfloat16, "mma"), (32, torch.bfloat16, "mma"), (96, torch.bfloat16, "mma"),
    (dw.MMA_MAX_K, torch.bfloat16, "mma"), (dw.MMA_MAX_K + 1, torch.bfloat16, "tc"),
    (70144, torch.bfloat16, "tc"),
])
def test_dw_route_by_dtype_and_k(k, dtype, route):
    """At K <= ``SIMT_MAX_K`` (fp32) or ``MMA_MAX_K`` (bf16: the pooler's
    K = 32 and MMBT's image embedding's 96 below it) the small-K kernels,
    which take K whole (no split): SIMT FMAs in fp32, ``mma.sync`` in bf16;
    above it fp32 runs the split-fp32 kernel, bf16 the stream-K one."""
    assert dw.dw_route(k, dtype) == route


def _small_k_tile(namespace: str = "simt") -> tuple:
    """A small-K kernel's (Dout, Din) output tile: ``BM`` and ``BN`` of the
    ``simt`` (fp32) or ``mma`` (bf16) namespace of ``csrc/dw.cu``."""
    import re

    from multimodal_uncertainty_tpu_torch.ops import _build

    text = (_build.CSRC_DIR / "dw.cu").read_text()
    body = text[text.index(f"namespace {namespace} {{"):text.index(f"}}  // namespace {namespace}")]
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", body).group(1))
                 for name in ("BM", "BN"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("din,dout", [(768, 768), (2048, 768)])
def test_small_k_tiles_give_every_sm_a_block(din, dout, dtype):
    """The small-K kernels' 64 x 64 output tiles at the main paths' shapes
    under their thresholds (the pooler's 768 x 768: 144 blocks; MMBT's image
    embedding, 2048 x 768: 384) make at least one block for each of an
    H100's 132 SMs, where the tensor-core kernels' 128 x 256 tiles make 18
    and 48 (the bf16 one's stream-K grid at K = 32: 18 blocks of one stage);
    a tile row of either input type is whole 16-byte copies."""
    fp32 = dtype == torch.float32
    rows, cols = _small_k_tile("simt" if fp32 else "mma")
    assert (rows, cols) == (64, 64)
    assert (dout // rows) * (din // cols) >= 132
    tile = dw.KERNELS[torch.float32][0] if fp32 else dw.STREAM_TILE
    assert (dout // tile[0]) * (din // tile[1]) < 132
    limit = dw.SIMT_MAX_K if fp32 else dw.MMA_MAX_K
    assert dw.dw_route(32, dtype) == dw.dw_route(limit, dtype) == ("simt" if fp32 else "mma")
    if dtype == torch.bfloat16:
        assert dw.stream_k_plan(32, din, dout, 132).grid == (dout // 128) * (din // 256)
    assert cols * torch.empty(0, dtype=dtype).element_size() % 16 == 0


WAVE_TAIL = 0.2  # the share of a run's block slots a split may leave idle


@pytest.mark.parametrize("k", [5280, 5920, 10240, 40960])
@pytest.mark.parametrize("din,dout", [(768, 3072), (3072, 768), (768, 2304), (768, 768)])
def test_fp32_splits_fill_their_waves(k, din, dout):
    """At the main paths' fp32 shapes (MMBT's K = 32 x 165, ViLT's 32 x 185,
    FLAVA's 32 x 320 and 128 x 320 rows; fc1, fc2, qkv, proj), the (tile,
    chunk) units of the chosen split fill at least 90 % of their last wave of
    132 blocks (one an SM), or leave at most ``WAVE_TAIL`` of all the run's
    slots idle: no second wave of a few blocks on an empty card, as the old
    rule of ceil(2 x SMs / tiles) splits gave (288 blocks for 264 slots)."""
    splits, _ = dw.k_splits(k, din, dout, 132)
    (bm, bn), _, _ = dw.KERNELS[torch.float32]
    units = (dout // bm) * -(-din // bn) * splits
    waves = -(-units // 132)
    last = units - (waves - 1) * 132
    assert last >= 0.9 * 132 or units >= (1 - WAVE_TAIL) * waves * 132, (splits, units, waves)


def _tf32(v):
    """Round fp32 to TF32 (10 mantissa bits) to nearest, ties away from zero,
    on the bit pattern: cvt.rna.tf32.f32, the 13 low bits cleared."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_split_fp32_product_meets_the_fp32_gate_and_one_tf32_product_does_not():
    """The kernel's arithmetic emulated on the CPU at ViLT's K = 5920 (widths
    128 x 64, randn): each operand v = hi + lo with hi = tf32(v), lo =
    tf32(v - hi); dY^T X as the three fp32 products lo·hi + hi·lo + hi·hi
    summed in fp32. Against float64 it is within the gate (1e-4 x max(1,
    max|ref|)) and within 2x plain fp32's own error; one TF32 product,
    tf32(dY)^T tf32(X) in fp32, misses the gate: why the split exists."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5920, 128)).astype(np.float32)
    dy = rng.standard_normal((5920, 64)).astype(np.float32)
    ref = dy.astype(np.float64).T @ x.astype(np.float64)
    tol = _tol(ref, 1e-4)

    def mm(a, b):  # a^T b, fp32 products summed in fp32
        return (torch.from_numpy(a).t() @ torch.from_numpy(b)).numpy()

    x_hi, dy_hi = _tf32(x), _tf32(dy)
    x_lo, dy_lo = _tf32(x - x_hi), _tf32(dy - dy_hi)
    split = mm(dy_lo, x_hi) + mm(dy_hi, x_lo) + mm(dy_hi, x_hi)  # fp32 sums
    plain_err = np.abs(mm(dy, x) - ref).max()
    split_err = np.abs(split - ref).max()
    one_err = np.abs(mm(dy_hi, x_hi) - ref).max()
    assert split_err <= tol and split_err <= 2 * plain_err, (split_err, plain_err, tol)
    assert one_err > tol, (one_err, tol)


def _counting(monkeypatch):
    calls = []
    real = dw.weight_grad

    def counted(x2d, dy2d):
        calls.append((tuple(x2d.shape), tuple(dy2d.shape)))
        return real(x2d, dy2d)

    monkeypatch.setattr(dw, "weight_grad", counted)
    return calls


def test_linear_takes_the_route_only_in_training_and_at_multiples_of_128(monkeypatch):
    calls = _counting(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    layers = {"128x256": Linear(128, 256, generator=gen),
              "128x101": Linear(128, 101, generator=gen),
              "96x128": Linear(96, 128, generator=gen)}
    model = torch.nn.ModuleDict(layers)
    set_fast_dw(model, True)
    for name, lin in layers.items():
        x = torch.randn(6, lin.weight.shape[1], generator=gen)
        lin.train()
        lin(x).sum().backward()
        lin.eval()
        lin(x).sum().backward()
    assert calls == [((6, 128), (6, 256))]  # 128x256 in training only
    lin = layers["128x256"]
    lin.train()
    lin.weight.requires_grad_(False)  # frozen: no dW, no launch
    lin(torch.randn(6, 128, requires_grad=True)).sum().backward()
    assert len(calls) == 1
    set_fast_dw(model, False)
    lin.weight.requires_grad_(True)
    lin(torch.randn(6, 128)).sum().backward()
    assert len(calls) == 1


def test_linear_with_and_without_the_route_agree():
    gen = torch.Generator().manual_seed(1)
    a, b = Linear(256, 384, generator=gen), Linear(256, 384)
    b.load_state_dict(a.state_dict())
    a.fast_dw = True
    x = torch.randn(2, 7, 256, generator=gen)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya, yb = a(xa), b(xb)
    g = torch.randn(ya.shape, generator=gen)
    ya.backward(g)
    yb.backward(g)
    torch.testing.assert_close(ya, yb, atol=1e-5, rtol=0)
    for p, q in ((a.weight.grad, b.weight.grad), (a.bias.grad, b.bias.grad), (xa.grad, xb.grad)):
        torch.testing.assert_close(p, q, atol=1e-4, rtol=1e-5)
