"""The port's attention backward against the JAX package's, on the CPU.

Inputs and the output cotangent are drawn with numpy from a seed and handed
to both sides. On the CPU the port runs its plain backward (the CUDA kernel
runs only on the card, where ``chip_smoke.py`` holds it against the same plain
version). The JAX side runs its Pallas kernels in interpret mode (K1 bwd
through ``impl="pallas_interpret"``, K3 bwd through ``_sdpa_flash_bwd_impl``
with ``interpret=True``) and its XLA path.

Tolerance 1e-5 absolute in fp32: the same math summed in another order (dK
and dV sum over S queries).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.ops import attention as JA
from multimodal_uncertainty_tpu_torch.ops import attention as TA

B, D, S = 5, 512, 40
TOL = 1e-5


def _mask(s: int, rng) -> np.ndarray:
    """The rows of ``tests/test_torch_attention.py::_mask``: 0 ragged (with
    holes), 1 image-ablated, 2 text-ablated, 3 fully masked, 4 ragged."""
    lengths = rng.integers(s // 2, s + 1, size=B)
    m = np.arange(s)[None, :] < lengths[:, None]
    m &= rng.random((B, s)) > 0.2
    m[:, 0] = True
    m[1, : s // 2] = False
    m[2, s // 2:] = False
    m[3] = False
    return m


def _t(x, requires_grad=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=requires_grad)


def _jax_packed_grad(qkv, mask, g, n_head, impl):
    _, vjp = jax.vjp(
        lambda t: JA.attention_qkv_packed(t, jnp.asarray(mask), n_head=n_head, impl=impl),
        jnp.asarray(qkv),
    )
    return np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
def test_packed_grad_matches_jax(impl, dh):
    """dQKV of the port's packed entry point equals JAX K1 bwd and XLA's,
    fully masked sample included."""
    rng = np.random.default_rng(10 + dh)
    qkv = rng.normal(size=(B, S, 3 * D)).astype(np.float32)
    mask = _mask(S, rng)
    g = rng.normal(size=(B, S, D)).astype(np.float32)
    n_head = D // dh
    ref = _jax_packed_grad(qkv, mask, g, n_head, impl)

    x = _t(qkv, requires_grad=True)
    out = TA.attention_qkv_packed(x, torch.from_numpy(mask), n_head=n_head)
    out.backward(_t(g))
    assert x.grad.shape == (B, S, 3 * D) and x.grad.dtype == torch.float32
    np.testing.assert_allclose(x.grad.numpy(), ref, atol=TOL, rtol=0)


def _lse_plain(lse_lanes: np.ndarray, n_head: int, dh: int) -> np.ndarray:
    """The JAX flash forward's (B, S, 128 * groups) lane-broadcast LSE ->
    (B, H, S), as ``tests/test_torch_attention.py::_jax_lse_plain``."""
    if dh >= 128:
        lanes = [128 * h for h in range(n_head)]
    else:
        g = 128 // dh
        lanes = [128 * (h // g) + (h % g) * dh for h in range(n_head)]
    return np.stack([lse_lanes[:, :, lane] for lane in lanes], axis=1)


@pytest.mark.parametrize("dh", [128, 64])
def test_flash_bwd_matches_jax_k3(dh):
    """attention_flash_bwd, fed the JAX flash forward's out and (converted)
    LSE, equals JAX K3 bwd on every sample with a kept key."""
    s, d = 128, 256  # a 128-multiple: the JAX flash kernels pad other lengths
    rng = np.random.default_rng(20 + dh)
    q, k, v, g = (rng.normal(size=(B, s, d)).astype(np.float32) for _ in range(4))
    mask = _mask(s, rng)
    n_head = d // dh
    mask_i32 = jnp.asarray(mask.astype(np.int32))[:, None, :]
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    j_out, j_lse = JA._sdpa_flash_fwd_impl(jq, jk, jv, mask_i32, n_head, True)
    ref = JA._sdpa_flash_bwd_impl(jq, jk, jv, mask_i32, jnp.asarray(g), j_out, j_lse,
                                  n_head, True)

    grads = TA.attention_flash_bwd(
        _t(q), _t(k), _t(v), torch.from_numpy(mask), _t(j_out),
        _t(_lse_plain(np.asarray(j_lse), n_head, dh)), _t(g), n_head=n_head,
    )
    kept = mask.any(axis=1)
    assert not kept.all()  # the fully masked sample is left out below
    for name, got, want in zip("qkv", grads, ref):
        assert got.shape == (B, s, d), name
        np.testing.assert_allclose(got.numpy()[kept], np.asarray(want)[kept],
                                   atol=TOL, rtol=0, err_msg=f"d{name}")


def test_fully_masked_sample_follows_k1_not_k3():
    """Pins the JAX package's divergence on a sample whose keys are all
    masked: the forward averages V uniformly, so the gradient is that of the
    uniform average. K1 and XLA give it; K3 gives exactly 0; the port gives
    what K1 and XLA give."""
    b, s, d = 2, 128, 256
    rng = np.random.default_rng(30)
    qkv = rng.normal(size=(b, s, 3 * d)).astype(np.float32)
    g = rng.normal(size=(b, s, d)).astype(np.float32)
    mask = rng.random((b, s)) > 0.3
    mask[0] = False
    xla = _jax_packed_grad(qkv, mask, g, 1, "xla")
    k1 = _jax_packed_grad(qkv, mask, g, 1, "pallas_interpret")
    k3 = _jax_packed_grad(qkv, mask, g, 1, "flash_interpret")

    x = _t(qkv, requires_grad=True)
    TA.attention_qkv_packed(x, torch.from_numpy(mask), n_head=1).backward(_t(g))
    port = x.grad.numpy()

    assert np.abs(xla[0]).max() > 0.05  # a real gradient on the masked sample
    np.testing.assert_allclose(k1[0], xla[0], atol=TOL, rtol=0)
    assert np.all(k3[0] == 0.0)
    np.testing.assert_allclose(port[0], xla[0], atol=TOL, rtol=0)
    for ref in (xla, k1, k3):  # the sample with kept keys: all agree
        np.testing.assert_allclose(port[1], ref[1], atol=TOL, rtol=0)


@pytest.mark.parametrize("dh", [64, 128, 256])
def test_bwd_plain_matches_autograd_of_fwd_plain(dh):
    rng = np.random.default_rng(40 + dh)
    q, k, v, g = (rng.normal(size=(B, S, D)).astype(np.float32) for _ in range(4))
    mask = torch.from_numpy(_mask(S, rng))
    n_head = D // dh
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    out, _ = TA.attention_fwd_plain(qt, kt, vt, mask, n_head=n_head)
    out.backward(_t(g))
    grads = TA.attention_bwd_plain(_t(q), _t(k), _t(v), mask, _t(g), n_head=n_head)
    for name, got, want in zip("qkv", grads, (qt.grad, kt.grad, vt.grad)):
        torch.testing.assert_close(got, want, atol=TOL, rtol=0, msg=f"d{name}")


def test_bwd_plain_bf16_rounds_p_and_ds_like_jax_k1():
    """In bf16 the plain backward rounds P and dS before their products, as
    ``_attn_bwd_kernel_hl`` does: it equals JAX K1 bwd in bf16 to within one
    bf16 rounding of the output (2e-2, as the forward's bf16 test)."""
    rng = np.random.default_rng(50)
    qkv = rng.normal(size=(B, S, 3 * 256)).astype(np.float32)
    mask = _mask(S, rng)
    g = rng.normal(size=(B, S, 256)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda t: JA.attention_qkv_packed(t, jnp.asarray(mask), n_head=2,
                                          impl="pallas_interpret"),
        jnp.asarray(qkv, jnp.bfloat16),
    )
    ref = np.asarray(vjp(jnp.asarray(g, jnp.bfloat16))[0].astype(jnp.float32))
    x = _t(qkv).to(torch.bfloat16).requires_grad_()
    TA.attention_qkv_packed(x, torch.from_numpy(mask), n_head=2).backward(
        _t(g).to(torch.bfloat16))
    assert x.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(x.grad.float().numpy(), ref, atol=2e-2 * max(1, np.abs(ref).max()),
                               rtol=0)


def test_cpu_route_runs_through_the_autograd_functions(monkeypatch):
    """Both entry points hand their output to a custom autograd Function
    whose backward is the plain backward on the CPU (the kernel's on the
    card): the gradient cannot skip the attention branch."""
    calls = []
    plain = TA.attention_bwd_plain

    def counting(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(TA, "attention_bwd_plain", counting)
    rng = np.random.default_rng(60)
    qkv = _t(rng.normal(size=(2, 9, 3 * 128)), requires_grad=True)
    out = TA.attention_qkv_packed(qkv, n_head=1)
    assert type(out.grad_fn).__name__ == "_PackedAttentionBackward"
    out.sum().backward()
    assert len(calls) == 1 and qkv.grad is not None and qkv.grad.abs().sum() > 0

    q, k, v = (_t(rng.normal(size=(2, 9, 128)), requires_grad=True) for _ in range(3))
    out, lse = TA.attention_flash_fwd(q, k, v, n_head=1)
    assert type(out.grad_fn).__name__ == "_AttentionBackward" and not lse.requires_grad
    out.sum().backward()
    assert len(calls) == 2 and all(t.grad is not None for t in (q, k, v))


def test_packed_grad_reaches_the_input_projection():
    """The slice-1 gap: a block's in_proj gets its gradient through the
    attention branch (with attention cut off, it would get none)."""
    from multimodal_uncertainty_tpu_torch.models.transformer import MultiHeadAttention

    attn = MultiHeadAttention(128, 1, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 9, 128, generator=torch.Generator().manual_seed(1))
    attn(x).square().sum().backward()
    assert attn.in_proj.weight.grad is not None
    assert attn.in_proj.weight.grad.abs().max() > 0


def test_bwd_wrapper_rejects_what_it_cannot_take():
    x = torch.zeros(1, 4, 3 * 128)
    q, k, v = x[..., :128], x[..., 128:256], x[..., 256:]
    lse = torch.zeros(1, 1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        TA.attention_bwd_cuda(q, k, v, None, q.contiguous(), lse, q.contiguous(), n_head=1)
    with pytest.raises(ValueError, match="device"):
        TA.attention_flash_bwd(*(t.to("meta") for t in (q, k, v)), None, q, lse, q,
                               n_head=1)
    with pytest.raises(ValueError, match="divisible"):
        TA.attention_flash_bwd(q, k, v, None, q, lse, q, n_head=3)


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("dh", [24, 32, 48, 64, 96, 128, 192, 256, 384, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_source_sends_bf16_dh64_96_256_without_dropout_to_the_tensor_cores(dtype, dh,
                                                                              dropout):
    """The backward's routes: every bf16 launch, at Dh 24-768 without dropout
    and at Dh 32 and 64 with it, to its head dim's tensor-core source; bf16
    dropout at a head dim with no instance raises; fp32 to the micro-tile and
    cluster instances. Every source named is built."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    if dtype == torch.bfloat16 and dropout and dh not in (32, 64):
        with pytest.raises(ValueError, match=f"no instance at Dh {dh}"):
            TA.bwd_source(dtype, dh, dropout)
        return
    source = TA.bwd_source(dtype, dh, dropout)
    if dtype == torch.bfloat16:
        assert source == TA.TC_BWD_SOURCE + TA._TC_SUFFIX[dh] == {
            24: "attention_bwd_tc_24", 32: "attention_bwd_tc_32", 48: "attention_bwd_tc_48",
            64: "attention_bwd_tc", 96: "attention_bwd_tc_k6", 128: "attention_bwd_tc_128",
            192: "attention_bwd_tc_192", 256: "attention_bwd_tc_256",
            384: "attention_bwd_tc_384", 768: "attention_bwd_tc_768"}[dh]
        assert source in TA.TC_BWD_SOURCES
    else:
        suffix = ("" if dh in (32, 64, 128) else "_k6" if dh in (24, 48, 96, 192)
                  else "_256" if dh == 256 else "_wide")
        assert source == "attention_bwd" + suffix
        assert source not in TA.TC_BWD_SOURCES
    assert source in _build.SOURCES


def test_no_bwd_source_is_named_for_the_forward_only_head_dims():
    """No head dim is the forward's alone: the tensor-core backward has a
    source wherever the forward has one (``TC_BWD_DIMS == TC_FWD_DIMS``), at
    Dh 384 and 768 ``csrc/attention_bwd_tc_384.cu`` / ``_768.cu`` on
    clusters, which ``bwd_source`` names for bf16 without dropout. fp32 there
    stays on the FMA cluster kernel, ``csrc/attention_bwd_wide.cu``; bf16
    with dropout there (no model path runs it) has no instance and raises.
    The dropout instances are the same in both directions (Dh 32 and 64)."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    assert TA.TC_BWD_DIMS == TA.TC_FWD_DIMS and {384, 768} <= set(TA.TC_BWD_DIMS)
    assert TA.TC_BWD_DROPOUT_DIMS == TA.TC_FWD_DROPOUT_DIMS == (32, 64)
    for dh in (384, 768):
        assert TA.bwd_source(torch.bfloat16, dh, False) == f"{TA.TC_BWD_SOURCE}_{dh}"
        assert (_build.CSRC_DIR / f"{TA.TC_BWD_SOURCE}_{dh}.cu").is_file()
        with pytest.raises(ValueError, match="no instance"):
            TA.bwd_source(torch.bfloat16, dh, True)
        assert TA.bwd_source(torch.float32, dh, False) == "attention_bwd_wide"


def test_every_bwd_source_is_built_and_exists():
    """Every source ``bwd_source`` can name, at every head dim, dtype and
    dropout, is one ``_build`` compiles and lies under ``csrc/``."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    named = {TA.bwd_source(dtype, dh, dropout)
             for dtype in (torch.float32, torch.bfloat16) for dropout in (False, True)
             for dh in TA.KERNEL_HEAD_DIMS[f"attention_bwd{'_dropout' if dropout else ''}_cuda"]}
    assert TA.TC_BWD_SOURCES == {TA.TC_BWD_SOURCE + TA._TC_SUFFIX[dh]
                                 for dh in TA.TC_BWD_DIMS}
    assert TA.TC_BWD_SOURCES <= named
    for name in named:
        assert name in _build.SOURCES
        assert (_build.CSRC_DIR / f"{name}.cu").is_file()


@pytest.mark.parametrize("dh", TA.TC_BWD_DIMS)
def test_tc_bwd_source_declares_pass_shapes_the_template_takes(dh):
    """Each tensor-core backward source defines its head dim and its passes'
    shapes (``MMU_BWD_TC_DQ``: BT, AREG, MINB; ``MMU_BWD_TC_DKV``: SPLIT, BT,
    AREG, MINB) within ``TcPass``'s checks in ``attention_bwd_tc.cuh``: 32- or
    64-row tiles, the exchange (SPLIT 2: column halves, only at a Dh of whole
    128-column pairs of panels; SPLIT 3: roles) only at 64-row tiles with the
    own operands in shared memory, one block's shared memory within the card's
    227 KB and MINB blocks within the SM's 228 KB (1 KB reserved a block), and
    the registers a thread holds across a tile (the own operands' A fragments
    with AREG, 4 a k16 step over Dh each; the outputs' accumulators; S and dP
    of the warpgroup's streamed rows) within its share at MINB blocks of 256
    threads. At Dh 384 and 768 the source includes
    ``attention_bwd_tc_wide.cuh``, whose ``BwdTcWide`` fixes the layout:
    192-column slices, Dh / 192 blocks a cluster (at most 8, the portable
    size), 64 own rows and 64-row streamed tiles, and the cluster's way of
    summing the partials (the all-read at 2 blocks: two buffers of both
    planes' partials; the reduce-scatter at 4: one buffer, the dQ pass's dS
    exchange tile and the own rows' info). Both passes' shared memory (own
    slices, ring, partials, exchange tiles, streamed rows' info, slack)
    within 227 KB, one block an SM; the registers a thread holds across a
    tile (one m64n192 output, S and dP of half a tile) within 255."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    text = (_build.CSRC_DIR / f"{TA.bwd_source(torch.bfloat16, dh, False)}.cu").read_text()

    def macro(name):
        found = re.search(rf"^#define {name} (.+)$", text, re.M)
        return tuple(int(x) for x in found.group(1).split(","))

    assert macro("MMU_BWD_TC_DH") == (dh,)
    if '#include "attention_bwd_tc_wide.cuh"' in text:
        wide = (_build.CSRC_DIR / "attention_bwd_tc_wide.cuh").read_text()
        c, rows, bt = (int(re.search(rf"static constexpr int {name} = (\d+);", wide).group(1))
                       for name in ("C", "kRows", "BT"))
        assert re.search(r"static constexpr int SUM = N == 2 \? 0 : 1;", wide)
        n = dh // c
        way = 0 if n == 2 else 1
        assert dh in (384, 768) and n * c == dh and n <= 8 and c % 64 == 0 and bt == 64
        assert not re.search(r"^#define MMU_BWD_TC_(DQ|DKV) ", text, re.M)
        for dq in (True, False):
            own, ring = 2 * c // 64 * rows * 128, 4 * c // 64 * bt * 128
            partials = (2 if way == 0 else 1) * 2 * rows * bt * 4
            xchg = (0 if way == 0 else 1) * rows * bt * 2 if dq else 2 * rows * bt * 2
            info = 2 * bt * (8 if dq else 16) + (rows * 16 if way else 0)
            smem = 1024 + own + ring + partials + xchg + info
            assert smem <= 232448 and smem + 1024 <= 233472, (dq, smem)
        regs = c // 2 + 2 * (bt // 2) // 2
        assert regs <= 255, regs
        return
    for dkv, (split, bt, areg, minb) in ((False, (1, *macro("MMU_BWD_TC_DQ"))),
                                          (True, macro("MMU_BWD_TC_DKV"))):
        assert bt in (32, 64) and areg in (0, 1) and minb >= 1
        assert split == 1 or (split in (2, 3) and dkv and bt == 64 and areg == 0)
        assert split != 2 or dh % 128 == 0
        panels = (dh + 63) // 64
        rows = 128 if split == 1 else 64
        own = 0 if areg else panels * rows * 128
        xchg = 2 * 64 * bt * 2 if split != 1 else 0
        smem = 1024 + 2 * own + 4 * panels * bt * 128 + xchg + 2 * bt * 16
        assert smem <= 232448 and minb * (smem + 1024) <= 233472, smem
        cols = dh // 2 if split == 2 else dh
        outputs = 1 if split == 3 or not dkv else 2
        streamed = bt if split == 1 else bt // 2
        regs = (2 * 4 * -(-dh // 16) if areg else 0) + outputs * cols // 2 + streamed
        assert regs <= min(255, 65536 // (256 * minb)), regs


@pytest.mark.parametrize("dtype,dh,dropout,lib,fn", [
    (torch.bfloat16, 64, False, "attention_bwd_tc", "mmu_attention_bwd_tc"),
    (torch.bfloat16, 64, True, "attention_bwd_tc", "mmu_attention_bwd_tc"),
    (torch.float32, 64, False, "attention_bwd", "mmu_attention_bwd"),
    (torch.bfloat16, 128, False, "attention_bwd_tc_128", "mmu_attention_bwd_tc"),
    (torch.bfloat16, 32, False, "attention_bwd_tc_32", "mmu_attention_bwd_tc"),
    (torch.bfloat16, 32, True, "attention_bwd_tc_32", "mmu_attention_bwd_tc"),
    (torch.bfloat16, 96, False, "attention_bwd_tc_k6", "mmu_attention_bwd_tc"),
    (torch.bfloat16, 96, True, None, None),
    (torch.float32, 96, False, "attention_bwd_k6", "mmu_attention_bwd"),
    (torch.bfloat16, 384, False, "attention_bwd_tc_384", "mmu_attention_bwd_tc"),
    (torch.bfloat16, 768, False, "attention_bwd_tc_768", "mmu_attention_bwd_tc"),
    (torch.float32, 768, False, "attention_bwd_wide", "mmu_attention_bwd"),
    (torch.bfloat16, 768, True, None, None),
    (torch.float32, 256, False, "attention_bwd_256", "mmu_attention_bwd"),
    (torch.bfloat16, 256, False, "attention_bwd_tc_256", "mmu_attention_bwd_tc"),
    (torch.bfloat16, 256, True, None, None),
])
def test_launch_bwd_runs_bf16_dh64_96_256_without_dropout_on_the_tensor_cores(
        monkeypatch, dtype, dh, dropout, lib, fn):
    """``_launch_bwd`` without a card: the operand checks and the library are
    stubbed (the stub records the library and entry point called), so only
    the route choice runs. bf16 at Dh 24-768 without dropout, and at Dh 32
    and 64 with it, takes its tensor-core source and counts in its wrapper's
    ``launches_tc``; bf16 with dropout elsewhere (``lib`` None) has no
    instance and raises before any launch; fp32 takes the micro-tile
    instances and does not count. Either entry point gets the keep mask's
    pointer (NULL without dropout)."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    called = []

    class _Lib:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, entry):
            def launch(*args):
                called.append((self.name, entry))
                keep_ptrs.append(args[5])
                return 0
            return launch

    keep_ptrs = []
    monkeypatch.setattr(_build, "load", _Lib)
    monkeypatch.setattr(TA, "_check_qkv", lambda q, k, v, n_head, who: q.stride(1))
    monkeypatch.setattr(TA, "_check_operand", lambda *a, **kw: None)
    monkeypatch.setattr(TA, "_check_keep", lambda *a, **kw: 2.0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type(
        "S", (), {"cuda_stream": 0})())
    b, s, n_head = 2, 5, 2
    d = n_head * dh
    q, k, v, out, g = (torch.zeros(b, s, d, dtype=dtype) for _ in range(5))
    lse = torch.zeros(b, n_head, s)
    keep = torch.ones(b, n_head, s, s, dtype=torch.uint8) if dropout else None
    wrapper = TA.attention_bwd_dropout_cuda if dropout else TA.attention_bwd_cuda
    before = (TA.attention_bwd_cuda.launches_tc, TA.attention_bwd_dropout_cuda.launches_tc)
    if lib is None:
        with pytest.raises(ValueError, match=f"no instance at Dh {dh}"):
            TA.attention_bwd_dropout_cuda(q, k, v, None, keep, out, lse, g, n_head=n_head,
                                          rate=0.5)
        assert called == [] and before == (TA.attention_bwd_cuda.launches_tc,
                                           TA.attention_bwd_dropout_cuda.launches_tc)
        return
    if dropout:
        TA.attention_bwd_dropout_cuda(q, k, v, None, keep, out, lse, g, n_head=n_head, rate=0.5)
    else:
        TA.attention_bwd_cuda(q, k, v, None, out, lse, g, n_head=n_head)
    assert called == [(lib, fn)]
    assert keep_ptrs == [keep.data_ptr() if dropout else None]
    moved = (TA.attention_bwd_cuda.launches_tc - before[0],
             TA.attention_bwd_dropout_cuda.launches_tc - before[1])
    tc = int(lib in TA.TC_BWD_SOURCES)
    assert moved == ((0, tc) if wrapper is TA.attention_bwd_dropout_cuda else (tc, 0))
