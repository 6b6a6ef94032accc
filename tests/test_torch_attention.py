"""The port's attention entry points against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both sides. On the CPU
the port runs its plain version (the CUDA kernel runs only on the card, where
``chip_smoke.py`` holds it against the same plain version). The JAX side runs
its Pallas kernels in interpret mode and its XLA path.

Tolerances: 1e-5 in fp32 (the same math summed in another order); 2e-2 in
bf16 (one bf16 rounding of the output, and the two frameworks round P at
different points).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.ops import attention as JA
from multimodal_uncertainty_tpu_torch.ops import attention as TA

B, D = 5, 256


def _mask(s: int, rng) -> np.ndarray:
    """One row of each serving case: 0 ragged (with holes), 1 image-ablated
    (a leading block of keys all masked), 2 text-ablated, 3 fully masked (a
    padded batch row), 4 ragged."""
    lengths = rng.integers(s // 2, s + 1, size=B)
    m = np.arange(s)[None, :] < lengths[:, None]
    m &= rng.random((B, s)) > 0.2
    m[:, 0] = True
    m[1, : s // 2] = False
    m[2, s // 2:] = False
    m[3] = False
    return m


def _inputs(seed: int, s: int, d: int = D):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, s, 3 * d)).astype(np.float32)
    return qkv, _mask(s, rng)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


@pytest.mark.parametrize("dh", [128, 64])
@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
def test_qkv_packed_matches_jax(impl, dh):
    qkv, mask = _inputs(1, 40)
    n_head = D // dh
    ref = JA.attention_qkv_packed(jnp.asarray(qkv), jnp.asarray(mask), n_head=n_head, impl=impl)
    out = TA.attention_qkv_packed(_t(qkv), torch.from_numpy(mask), n_head=n_head)
    assert out.shape == (B, 40, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def _jax_lse_plain(lse_lanes: np.ndarray, n_head: int, dh: int) -> np.ndarray:
    """(B, S, 128 * groups) lane-broadcast LSE -> (B, H, S): head h sits at
    lane 128 h (Dh >= 128) or 128 (h // g) + (h % g) Dh with g = 128 // Dh."""
    if dh >= 128:
        lanes = [128 * h for h in range(n_head)]
    else:
        g = 128 // dh
        lanes = [128 * (h // g) + (h % g) * dh for h in range(n_head)]
    return np.stack([lse_lanes[:, :, lane] for lane in lanes], axis=1)


@pytest.mark.parametrize("dh", [128, 64])
def test_flash_fwd_matches_jax_out_and_lse(dh):
    s = 128  # a 128-multiple: the JAX flash kernels pad other lengths
    qkv, mask = _inputs(2, s)
    n_head = D // dh
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    out, lse = TA.attention_flash_fwd(
        _t(q), _t(k), _t(v), torch.from_numpy(mask), n_head=n_head
    )
    assert lse.shape == (B, n_head, s) and lse.dtype == torch.float32

    ref = JA.attention_qkv_packed(jnp.asarray(qkv), jnp.asarray(mask), n_head=n_head,
                                  impl="flash_interpret")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)

    mask_i32 = jnp.asarray(mask.astype(np.int32))[:, None, :]
    ref_out, ref_lse = JA._sdpa_flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask_i32, n_head, True
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        lse.numpy(), _jax_lse_plain(np.asarray(ref_lse), n_head, dh), atol=1e-5, rtol=1e-6
    )


@pytest.mark.parametrize("dh,n_head", [(128, 2), (64, 4), (256, 3)])
@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
def test_qkv_packed_bf16_matches_jax_bf16(impl, dh, n_head):
    """bf16 through the plain forward (which the card's kernels are held to)
    against JAX's K1 in interpret mode and its XLA path; Dh 256 at FLAVA's 3
    heads."""
    qkv, mask = _inputs(3, 40, dh * n_head)
    ref = JA.attention_qkv_packed(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(mask),
                                  n_head=n_head, impl=impl)
    out = TA.attention_qkv_packed(_t(qkv, torch.bfloat16), torch.from_numpy(mask),
                                  n_head=n_head)
    assert out.dtype == torch.bfloat16 and out.shape == (B, 40, dh * n_head)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2, rtol=0)


def test_fully_masked_row_is_uniform_average_of_v():
    """The -1e30 contract: a row with every key masked averages V over all
    S keys (not NaN, not 0), and its LSE is -1e30 + log S = -1e30."""
    rng = np.random.default_rng(4)
    q, k, v = (_t(rng.normal(size=(2, 9, 128))) for _ in range(3))
    mask = torch.ones(2, 9, dtype=torch.bool)
    mask[0] = False
    out, lse = TA.attention_flash_fwd(q, k, v, mask, n_head=1)
    torch.testing.assert_close(out[0], v[0].mean(0).expand(9, -1), atol=1e-6, rtol=0)
    assert torch.all(lse[0] == TA.NEG_INF)
    assert torch.isfinite(out).all()


def test_kernel_library_is_named_by_source_and_flags(monkeypatch):
    """A changed source or flag set builds a new library: a stale one is never loaded."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    path = _build.library_path("attention_fwd_tc")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libattention_fwd_tc-")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("attention_fwd_tc") != path
    try:
        nvcc = _build.nvcc()
    except RuntimeError as e:  # no CUDA toolkit on this machine: the build refuses
        assert "nvcc not found" in str(e)
    else:
        assert nvcc.endswith("nvcc")


def test_kernel_wrapper_rejects_what_it_cannot_take():
    x = torch.zeros(1, 4, 3 * 128)
    with pytest.raises(ValueError, match="CUDA"):
        TA.attention_fwd_cuda(x[..., :128], x[..., 128:256], x[..., 256:], n_head=1)
    with pytest.raises(ValueError, match="device"):
        TA.attention_qkv_packed(x.to("meta"), n_head=1)
    with pytest.raises(ValueError, match="split"):
        TA.attention_qkv_packed(torch.zeros(1, 4, 3 * 130), n_head=4)


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("dh", [24, 32, 48, 64, 96, 128, 192, 256, 384, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_source_sends_bf16_dh64_96_256_without_dropout_to_the_tensor_cores(dtype, dh,
                                                                              dropout):
    """The forward's routes: every bf16 launch, at Dh 24-768 without dropout
    and at Dh 32 and 64 with it (K5, the tiny BERT's and BERT-base's head
    dims), to the bf16 tensor-core kernels (``attention_fwd_tc{_24,_32,_48,,
    _k6,_128,_192,_256,_384,_768}``, one source a head dim); bf16 dropout at a
    head dim with no instance raises; fp32 at Dh 24-192 with or without
    dropout to the split-fp32 tensor-core kernels (``attention_fwd_tc32{,
    _k6}``), fp32 at Dh 256, 384 and 768 to the micro-tile and cluster
    kernels. No fp32 forward names a bf16 tensor-core source, and every
    source named is built and lies under ``csrc/``."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    if dtype == torch.bfloat16 and dropout and dh not in (32, 64):
        with pytest.raises(ValueError, match=f"no instance at Dh {dh}"):
            TA.fwd_source(dtype, dh, dropout)
        return
    source = TA.fwd_source(dtype, dh, dropout)
    suffix = ("" if dh in (32, 64, 128) else "_k6" if dh in (24, 48, 96, 192)
              else "_256" if dh == 256 else "_wide")
    if dtype == torch.bfloat16:
        assert source == {
            24: "attention_fwd_tc_24", 32: "attention_fwd_tc_32", 48: "attention_fwd_tc_48",
            64: "attention_fwd_tc", 96: "attention_fwd_tc_k6", 128: "attention_fwd_tc_128",
            192: "attention_fwd_tc_192", 256: "attention_fwd_tc_256",
            384: "attention_fwd_tc_384", 768: "attention_fwd_tc_768"}[dh]
        assert source in TA.TC_FWD_SOURCES
    else:
        assert source not in TA.TC_FWD_SOURCES
        if dh <= 192:
            assert source == TA.TC32_FWD_SOURCE + suffix == "attention_fwd_tc32" + suffix
        else:
            assert source == "attention_fwd" + suffix
    assert source in _build.SOURCES and (_build.CSRC_DIR / f"{source}.cu").is_file()
    assert TA.TC_FWD_SOURCES <= set(_build.SOURCES)
    assert all((_build.CSRC_DIR / f"{name}.cu").is_file() for name in _build.SOURCES)


@pytest.mark.parametrize("dtype,dh,dropout,lib,fn", [
    (torch.bfloat16, 64, False, "attention_fwd_tc", "mmu_attention_fwd_tc"),
    (torch.bfloat16, 64, True, "attention_fwd_tc", "mmu_attention_fwd_tc"),
    (torch.bfloat16, 32, True, "attention_fwd_tc_32", "mmu_attention_fwd_tc"),
    (torch.float32, 64, False, "attention_fwd_tc32", "mmu_attention_fwd"),
    (torch.float32, 64, True, "attention_fwd_tc32", "mmu_attention_fwd"),
    (torch.float32, 96, False, "attention_fwd_tc32_k6", "mmu_attention_fwd"),
    (torch.float32, 128, False, "attention_fwd_tc32", "mmu_attention_fwd"),
    (torch.float32, 192, False, "attention_fwd_tc32_k6", "mmu_attention_fwd"),
    (torch.bfloat16, 192, False, "attention_fwd_tc_192", "mmu_attention_fwd_tc"),
    (torch.bfloat16, 32, False, "attention_fwd_tc_32", "mmu_attention_fwd_tc"),
    (torch.bfloat16, 128, False, "attention_fwd_tc_128", "mmu_attention_fwd_tc"),
    (torch.bfloat16, 96, False, "attention_fwd_tc_k6", "mmu_attention_fwd_tc"),
    (torch.bfloat16, 768, False, "attention_fwd_tc_768", "mmu_attention_fwd_tc"),
    (torch.float32, 384, False, "attention_fwd_wide", "mmu_attention_fwd"),
    (torch.float32, 256, False, "attention_fwd_256", "mmu_attention_fwd"),
    (torch.bfloat16, 256, False, "attention_fwd_tc_256", "mmu_attention_fwd_tc"),
])
def test_launch_fwd_routes_by_dtype_head_dim_and_dropout(monkeypatch, dtype, dh, dropout, lib,
                                                         fn):
    """``_launch_fwd`` without a card: the operand checks and the library are
    stubbed (the stub records the library and entry point called), so only
    the route choice runs. bf16 at Dh 24-768 without dropout, and at Dh 32
    and 64 with it, takes its tensor-core source and counts in its wrapper's
    ``launches_tc`` (the tensor-core entry point gets the keep mask's
    pointer, NULL without dropout), fp32 at Dh 24-192 the split-fp32 one and
    counts in its wrapper's ``launches_tc32``; everything else counts in
    neither."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    called, keep_ptrs = [], []

    class _Lib:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, entry):
            def launch(*args):
                called.append((self.name, entry))
                keep_ptrs.append(args[5])
                return 0
            return launch

    monkeypatch.setattr(_build, "load", _Lib)
    monkeypatch.setattr(TA, "_check_qkv", lambda q, k, v, n_head, who: q.stride(1))
    monkeypatch.setattr(TA, "_check_keep", lambda *a, **kw: 2.0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type(
        "S", (), {"cuda_stream": 0})())
    b, s, n_head = 2, 5, 2
    d = n_head * dh
    q, k, v = (torch.zeros(b, s, d, dtype=dtype) for _ in range(3))
    keep = torch.ones(b, n_head, s, s, dtype=torch.uint8) if dropout else None
    wrapper = TA.attention_fwd_dropout_cuda if dropout else TA.attention_fwd_cuda
    other = TA.attention_fwd_cuda if dropout else TA.attention_fwd_dropout_cuda
    before = (wrapper.launches_tc, wrapper.launches_tc32, other.launches_tc)
    if dropout:
        out, lse = TA.attention_fwd_dropout_cuda(q, k, v, None, keep, n_head=n_head, rate=0.5)
    else:
        out, lse = TA.attention_fwd_cuda(q, k, v, None, n_head=n_head)
    assert called == [(lib, fn)]
    if fn == "mmu_attention_fwd_tc" or dropout:  # both entry points take it at argument 5
        assert keep_ptrs == [keep.data_ptr() if dropout else None]
    assert out.shape == (b, s, d) and out.dtype == dtype and lse.shape == (b, n_head, s)
    assert wrapper.launches_tc - before[0] == (lib in TA.TC_FWD_SOURCES)
    assert wrapper.launches_tc32 - before[1] == lib.startswith("attention_fwd_tc32")
    assert other.launches_tc == before[2]


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("dh", [24, 32, 48, 64, 96, 128, 192, 256, 384, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_fwd_runs_bf16_dh64_96_256_without_dropout_on_the_tensor_cores(
        monkeypatch, dtype, dh, dropout):
    """``_launch_fwd`` without a card at every (dtype, Dh, dropout): the
    operand checks and the library are stubbed (the stub records the library
    and entry point called). bf16 at every head dim without dropout, and at
    Dh 32 and 64 with it, loads its ``attention_fwd_tc*`` library, calls
    ``mmu_attention_fwd_tc`` and counts one in its wrapper's ``launches_tc``
    only; bf16 dropout at another head dim raises before any launch; the
    split-fp32 sources, whose name ``attention_fwd_tc32`` starts with the bf16
    route's, call ``mmu_attention_fwd`` and count in their wrapper's
    ``launches_tc32`` only; every other launch counts in neither."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    called = []

    class _Lib:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, entry):
            def launch(*args):
                called.append((self.name, entry))
                return 0
            return launch

    monkeypatch.setattr(_build, "load", _Lib)
    monkeypatch.setattr(TA, "_check_qkv", lambda q, k, v, n_head, who: q.stride(1))
    monkeypatch.setattr(TA, "_check_keep", lambda *a, **kw: 2.0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type(
        "S", (), {"cuda_stream": 0})())
    tc = dtype == torch.bfloat16
    tc32 = dtype == torch.float32 and dh <= 192
    b, s, n_head = 2, 3, 768 // dh
    q, k, v = (torch.zeros(b, s, 768, dtype=dtype) for _ in range(3))
    counters = (TA.attention_fwd_cuda.launches_tc, TA.attention_fwd_cuda.launches_tc32,
                TA.attention_fwd_dropout_cuda.launches_tc32,
                TA.attention_fwd_dropout_cuda.launches_tc)
    if tc and dropout and dh not in (32, 64):
        keep = torch.ones(b, n_head, s, s, dtype=torch.uint8)
        with pytest.raises(ValueError, match=f"no instance at Dh {dh}"):
            TA.attention_fwd_dropout_cuda(q, k, v, None, keep, n_head=n_head, rate=0.5)
        assert called == [] and counters == (
            TA.attention_fwd_cuda.launches_tc, TA.attention_fwd_cuda.launches_tc32,
            TA.attention_fwd_dropout_cuda.launches_tc32, TA.attention_fwd_dropout_cuda.launches_tc)
        return
    if dropout:
        keep = torch.ones(b, n_head, s, s, dtype=torch.uint8)
        TA.attention_fwd_dropout_cuda(q, k, v, None, keep, n_head=n_head, rate=0.5)
    else:
        TA.attention_fwd_cuda(q, k, v, None, n_head=n_head)
    source = TA.fwd_source(dtype, dh, dropout)
    assert called == [(source, "mmu_attention_fwd_tc" if tc else "mmu_attention_fwd")]
    assert (source in TA.TC_FWD_SOURCES) == tc
    assert source.startswith(TA.TC32_FWD_SOURCE) == tc32
    moved = (TA.attention_fwd_cuda.launches_tc - counters[0],
             TA.attention_fwd_cuda.launches_tc32 - counters[1],
             TA.attention_fwd_dropout_cuda.launches_tc32 - counters[2],
             TA.attention_fwd_dropout_cuda.launches_tc - counters[3])
    assert moved == (int(tc and not dropout), int(tc32 and not dropout), int(tc32 and dropout),
                     int(tc and dropout))


def _instance_lists() -> dict:
    """{source: {(direction, dtype, dropout): head dims}} as the CUDA sources
    declare them: the fp32 lists of the split-fp32 and micro-tile sources
    (``#define MMU_{FWD,BWD}_{PLAIN,DROPOUT}_DIMS`` in ``csrc/*.cu``), and
    each bf16 tensor-core source's ``#define MMU_FWD_TC_DH`` or
    ``#define MMU_BWD_TC_DH`` (with ``#define MMU_FWD_TC_DROPOUT`` /
    ``MMU_BWD_TC_DROPOUT`` the source holds the dropout instance of that head
    dim too)."""
    import re

    from multimodal_uncertainty_tpu_torch.ops import _build

    lists = {}
    for path in sorted(_build.CSRC_DIR.glob("attention_*.cu")):
        text = path.read_text()
        held = {}
        for direction in ("fwd", "bwd"):
            if re.search(rf'^#include "attention_{direction}_tc(_wide)?\.cuh"$', text, re.M):
                tc_dh = re.search(rf"^#define MMU_{direction.upper()}_TC_DH (\d+)$", text, re.M)
                held[(direction, torch.bfloat16, False)] = (int(tc_dh.group(1)),)
                if re.search(rf"^#define MMU_{direction.upper()}_TC_DROPOUT$", text, re.M):
                    held[(direction, torch.bfloat16, True)] = (int(tc_dh.group(1)),)
        for m in re.finditer(r"^#define MMU_(FWD|BWD)_(PLAIN|DROPOUT)_DIMS([^\n]*)$", text, re.M):
            held[(m[1].lower(), torch.float32, m[2] == "DROPOUT")] = tuple(
                int(x) for x in re.findall(r"\d+", m[3]))
        lists[path.stem] = held
    return lists


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_head_dim_has_exactly_one_source_and_it_is_the_routed_one(direction, dtype):
    """Every head dim of ``KERNEL_HEAD_DIMS`` (with and without dropout) is
    held by exactly one CUDA source in each direction and dtype, that source
    is the one ``fwd_source`` / ``bwd_source`` names, and every instance a
    source declares is routed to it."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    lists = _instance_lists()
    route = TA.fwd_source if direction == "fwd" else TA.bwd_source
    for dropout in (False, True):
        key = (direction, dtype, dropout)
        who = f"attention_{direction}{'_dropout' if dropout else ''}_cuda"
        for dh in TA.KERNEL_HEAD_DIMS[who]:
            holders = [src for src, held in lists.items() if dh in held.get(key, ())]
            assert holders == [route(dtype, dh, dropout)], (key, dh, holders)
            assert holders[0] in _build.SOURCES
        for src, held in lists.items():
            for dh in held.get(key, ()):
                assert dh in TA.KERNEL_HEAD_DIMS[who] and route(dtype, dh, dropout) == src, (
                    key, src, dh)


@pytest.mark.parametrize("source,key,dims", [
    ("attention_bwd_wide", ("bwd", torch.bfloat16, False), ()),
    ("attention_bwd_wide", ("bwd", torch.float32, False), (384, 768)),
    ("attention_fwd_tc_32", ("fwd", torch.bfloat16, True), (32,)),
    ("attention_fwd_tc_128", ("fwd", torch.bfloat16, False), (128,)),
    ("attention_fwd_tc", ("fwd", torch.bfloat16, True), (64,)),
    ("attention_bwd_tc_384", ("bwd", torch.bfloat16, False), (384,)),
    ("attention_bwd_tc_768", ("bwd", torch.bfloat16, False), (768,)),
    ("attention_bwd", ("bwd", torch.bfloat16, False), ()),
    ("attention_bwd", ("bwd", torch.bfloat16, True), ()),
    ("attention_bwd_tc_32", ("bwd", torch.bfloat16, True), (32,)),
    ("attention_bwd_tc_128", ("bwd", torch.bfloat16, False), (128,)),
])
def test_sources_hold_the_instances_their_routes_need(source, key, dims):
    """The instance lists the redesigns left: the FMA backward
    (``attention_bwd.cu``, ``attention_bwd_wide.cu``) builds fp32 only, no
    bf16 instance at all; the bf16 dropout forward and backward are the
    tensor-core sources' (``attention_{fwd,bwd}_tc.cu`` at BERT-base's Dh 64,
    ``attention_{fwd,bwd}_tc_32.cu`` at the tiny BERT's Dh 32, with
    ``MMU_FWD_TC_DROPOUT`` / ``MMU_BWD_TC_DROPOUT``); the bf16 attention at Dh
    128, 384 and 768 has one source a direction on the tensor cores."""
    assert _instance_lists()[source].get(key, ()) == dims


def _entry_body(source: str) -> str:
    """The C entry point of the header ``csrc/<source>.cu`` includes, as the
    preprocessor leaves it with the source's defines: ``#ifdef`` / ``#ifndef``
    blocks kept or dropped by whether the source defines their macro."""
    import re

    from multimodal_uncertainty_tpu_torch.ops import _build

    text = (_build.CSRC_DIR / f"{source}.cu").read_text()
    defined = set(re.findall(r"^#define (\w+)", text, re.M))
    header = re.search(r'^#include "(\w+\.cuh)"$', text, re.M).group(1)
    body = re.search(r'extern "C" int mmu_attention_\w+\(.*?\n\}',
                     (_build.CSRC_DIR / header).read_text(), re.S).group(0)
    kept, stack = [], []
    for line in body.splitlines():
        directive = re.match(r"#(ifdef|ifndef|else|endif)\s*(\w*)", line.strip())
        if directive is None:
            if all(stack):
                kept.append(line)
        elif directive[1] in ("ifdef", "ifndef"):
            stack.append((directive[2] in defined) == (directive[1] == "ifdef"))
        elif directive[1] == "else":
            stack[-1] = not stack[-1]
        else:
            stack.pop()
    return "\n".join(kept)


@pytest.mark.parametrize("source", sorted(TA.TC_FWD_SOURCES | TA.TC_BWD_SOURCES))
def test_tc_sources_refuse_a_keep_mask_unless_they_hold_the_dropout_instance(source):
    """Every bf16 tensor-core source's entry point returns
    cudaErrorInvalidValue for a keep mask, but ``attention_{fwd,bwd}_tc.cu``
    and ``attention_{fwd,bwd}_tc_32.cu``, which define ``MMU_FWD_TC_DROPOUT``
    / ``MMU_BWD_TC_DROPOUT`` and take it (the K5 routes at Dh 64 and 32), so
    that a dropout launch routed to a source without the instance fails
    loudly instead of running without dropout."""
    import re

    from multimodal_uncertainty_tpu_torch.ops import _build

    text = (_build.CSRC_DIR / f"{source}.cu").read_text()
    holds = bool(re.search(r"^#define MMU_(FWD|BWD)_TC_DROPOUT$", text, re.M))
    assert holds == (source in ("attention_fwd_tc", "attention_bwd_tc", "attention_fwd_tc_32",
                                "attention_bwd_tc_32"))
    refuses = re.search(r"keep != nullptr\)\s*return \(int\)cudaErrorInvalidValue;",
                        _entry_body(source))
    assert bool(refuses) != holds


# the micro-tile kernels' shapes: csrc/attention_{bwd,fwd}_wide.cuh and the sources that
# include them; an SM has 228 KB of shared memory (227 KB a block, 1 KB reserved a block) and
# 64 K registers
SM_SMEM, BLOCK_SMEM, RESERVED, THREADS, TILE = 228 * 1024, 227 * 1024, 1024, 256, 32
WIDE_BWD_DIMS, WIDE_FWD_DIMS = (24, 32, 48, 64, 96, 128, 192, 256, 384, 768), (256, 384, 768)
DROPOUT_BWD_DIMS = (32, 64)


def _wide_traits(header: str, trait: str = "Wide") -> dict:
    """{dh: {"N", "C", "R", "GC"[, "MINB"]}} as the ``Wide<DH>`` (or
    ``trait``) specialisations of ``csrc/<header>`` declare them."""
    import re

    from multimodal_uncertainty_tpu_torch.ops import _build

    text = (_build.CSRC_DIR / header).read_text()
    traits = {}
    for m in re.finditer(rf"struct {trait}<(\d+)> \{{[^}}]*?static constexpr int ([^;]*);", text):
        traits[int(m[1])] = {k.strip(): int(v) for k, v in
                             (kv.split("=") for kv in m[2].split(","))}
    return traits


def _pitch(c: int) -> int:
    """Floats a C-float row takes in shared memory (attention_cluster.cuh's pitch)."""
    return c if (c // 4) % 8 == 0 else c + 4


def _at(c: int, r: int, chunk: int) -> int:
    """Float offset of chunk ``chunk`` of row ``r`` (attention_cluster.cuh's at)."""
    if (c // 4) % 8 == 0:
        return r * c + ((chunk ^ (r & 7)) << 2)
    return r * (c + 4) + (chunk << 2)


def _assert_conflict_free(loads):
    """``loads``: the float offsets of one 16-byte load by each thread of a
    warp. Each quarter warp's 8 loads hit distinct 16-byte bank slots or the
    same word."""
    for q in range(0, 32, 8):
        words = set(loads[q:q + 8])
        assert len({(w // 4) % 8 for w in words}) == len(words), loads[q:q + 8]


def test_every_micro_tile_instance_has_a_shape():
    """Every head dim a source instantiates from a micro-tile header has its
    ``Wide<DH>`` shape there, and every shape is instantiated."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    for header, trait, dropout, dims in (
            ("attention_bwd_wide.cuh", "Wide", False, WIDE_BWD_DIMS),
            ("attention_bwd_wide.cuh", "WideDropout", True, DROPOUT_BWD_DIMS),
            ("attention_fwd_wide.cuh", "Wide", False, WIDE_FWD_DIMS)):
        held = set()
        for src, lists in _instance_lists().items():
            if f'#include "{header}"' in (_build.CSRC_DIR / f"{src}.cu").read_text():
                held |= {dh for key, dims_ in lists.items() if key[2] == dropout for dh in dims_}
        assert held == set(_wide_traits(header, trait)) == set(dims), (header, trait, held)


@pytest.mark.parametrize("trait,dh", [("Wide", dh) for dh in WIDE_BWD_DIMS]
                         + [("WideDropout", dh) for dh in DROPOUT_BWD_DIMS])
def test_backward_micro_tiles_own_every_position_once_and_fit_the_sm(trait, dh):
    """The backward's (N, C, R) thread maps (attention_bwd_wide.cuh's Shape):
    the score micro-tiles, the halves of the slice's chunks, the partials'
    float4 slots (as published and as the P / dS roles read them over the
    cluster), and the product micro-tiles each own every position of their
    tile exactly once; their shared-memory loads are bank-conflict free;
    MINB blocks fit an SM's shared memory; the dK and dV (or two dQ halves)
    accumulators, 2 R C over 256 threads, take at most half a thread's
    registers. ``WideDropout`` holds the dropout instances' shapes."""
    w = _wide_traits("attention_bwd_wide.cuh", trait)[dh]
    n, c, r, gc, minb = w["N"], w["C"], w["R"], w["GC"], w["MINB"]
    assert n * c == dh and c % 8 == 0 and r in (32, 64) and (r * TILE // 4) % n == 0
    chunks, ld = c // 4, _pitch(c)
    mj, rg_n, tg_n = r // 8, r // 4, TILE // (r // 8)
    # scores: 64 threads a (matrix, half), 4 x mj each
    owned = [(i64 // tg_n + rg_n * i, i64 % tg_n + tg_n * j)
             for i64 in range(64) for i in range(4) for j in range(mj)]
    assert sorted(owned) == [(row, t) for row in range(r) for t in range(TILE)]
    assert chunks % 2 == 0  # the two halves split the chunks
    # published slot kk * 64 + i64 holds rows rg + kRG (kk / (mj / 4)), tile rows tg + kTG
    # (4 (kk % (mj / 4)) + e)
    published = {}
    for i64 in range(64):
        for kk in range(mj):
            i, j = kk // (mj // 4), 4 * (kk % (mj // 4))
            published[kk * 64 + i64] = [(i64 // tg_n + rg_n * i, i64 % tg_n + tg_n * (j + e))
                                        for e in range(4)]
    # P / dS roles: block `rank` forms slots rank * share + tid + 256 u
    share = r * TILE // 4 // n
    iters = -(-share // THREADS)
    formed = []
    for rank in range(n):
        for tid in range(THREADS):
            for u in range(iters):
                if tid + THREADS * u >= share:
                    continue
                slot = rank * share + tid + THREADS * u
                pkk, pi64 = slot // 64, slot % 64
                prow = pi64 // tg_n + rg_n * (pkk // (mj // 4))
                pt0 = pi64 % tg_n + tg_n * 4 * (pkk % (mj // 4))
                got = [(prow, pt0 + tg_n * e) for e in range(4)]
                assert got == published[slot]
                formed += got
    assert sorted(formed) == [(row, t) for row in range(r) for t in range(TILE)]
    # products: 128 threads a group, kPI rows x kPJ chunks each
    gr = 128 // gc
    assert 128 % gc == 0 and r % gr == 0 and chunks % gc == 0
    pi, pj = r // gr, chunks // gc
    owned = [(tid // gc + gr * i, tid % gc + gc * j)
             for tid in range(128) for i in range(pi) for j in range(pj)]
    assert sorted(owned) == [(row, ch) for row in range(r) for ch in range(chunks)]
    # shared-memory loads of one warp: scores' streamed rows and own rows, the products'
    # streamed rows (row t) and P / dS rows
    for wp in range(2):
        lanes = [wp * 32 + lane for lane in range(32)]
        for ch in range(chunks):
            for j in range(mj):
                _assert_conflict_free([_at(c, i64 % tg_n + tg_n * j, ch) for i64 in lanes])
            for i in range(4):
                _assert_conflict_free([_at(c, i64 // tg_n + rg_n * i, ch) for i64 in lanes])
    for warp in range(4):
        lanes = [warp * 32 + lane for lane in range(32)]
        for j in range(pj):
            _assert_conflict_free([_at(c, 5, tid % gc + gc * j) for tid in lanes])
        for i in range(pi):
            _assert_conflict_free([_at(TILE, tid // gc + gr * i, 3) for tid in lanes])
    # shared memory: own rows, the stream ring, partials, P / dS, row info
    smem = (2 * r * ld + 2 * 2 * TILE * ld + 2 * r * TILE + 2 * r * TILE) * 4 + 2 * TILE * 16
    assert smem <= BLOCK_SMEM and minb * (smem + RESERVED) <= SM_SMEM, smem
    assert r * c <= 2 * 2 * TILE * ld  # dQ's second half fits the stream area
    budget = min(255, 65536 // (THREADS * minb))
    assert 2 * r * c // THREADS <= budget // 2, (2 * r * c // THREADS, budget)


@pytest.mark.parametrize("dh", WIDE_FWD_DIMS)
def test_forward_micro_tiles_own_every_position_once_and_fit_the_sm(dh):
    """The forward's (N, C, R) thread maps (attention_fwd_wide.cuh's Shape):
    the score micro-tiles of each half, the softmax rows of the warps and the
    product micro-tiles each own every position of their tile once; the
    partial-score permutation keeps each row's keys and spreads a warp's
    stores over distinct banks; shared-memory loads are conflict free; one
    block fits an SM; the R x C accumulators over 256 threads take at most
    half a thread's 255 registers."""
    w = _wide_traits("attention_fwd_wide.cuh")[dh]
    n, c, r, gc = w["N"], w["C"], w["R"], w["GC"]
    assert n * c == dh and c % 8 == 0 and r in (32, 64)
    chunks, ld = c // 4, _pitch(c)
    mj, rg_n = r // 16, r // 4
    tg_n = TILE // mj
    owned = [(i128 // tg_n + rg_n * i, i128 % tg_n + tg_n * j)
             for i128 in range(128) for i in range(4) for j in range(mj)]
    assert sorted(owned) == [(row, t) for row in range(r) for t in range(TILE)]
    assert chunks % 2 == 0

    def at_part(row, t):
        return row * TILE + (t ^ ((row % (TILE // tg_n)) * tg_n))

    for row in range(r):
        assert sorted(at_part(row, t) - row * TILE for t in range(TILE)) == list(range(TILE))
    for warp in range(4):
        for i in range(4):
            for j in range(mj):
                banks = [at_part(i128 // tg_n + rg_n * i, i128 % tg_n + tg_n * j) % 32
                         for i128 in range(warp * 32, warp * 32 + 32)]
                assert len(set(banks)) == 32, banks
        for ch in range(chunks):
            for j in range(mj):
                _assert_conflict_free([_at(c, i128 % tg_n + tg_n * j, ch)
                                       for i128 in range(warp * 32, warp * 32 + 32)])
            for i in range(4):
                _assert_conflict_free([_at(c, i128 // tg_n + rg_n * i, ch)
                                       for i128 in range(warp * 32, warp * 32 + 32)])
    assert sorted(w_ * (r // 8) + rr for w_ in range(8) for rr in range(r // 8)) == list(range(r))
    gr = THREADS // gc
    assert THREADS % gc == 0 and r % gr == 0 and chunks % gc == 0
    pi, pj = r // gr, chunks // gc
    owned = [(tid // gc + gr * i, tid % gc + gc * j)
             for tid in range(THREADS) for i in range(pi) for j in range(pj)]
    assert sorted(owned) == [(row, ch) for row in range(r) for ch in range(chunks)]
    for warp in range(8):
        lanes = range(warp * 32, warp * 32 + 32)
        for j in range(pj):
            _assert_conflict_free([_at(c, 7, tid % gc + gc * j) for tid in lanes])
    smem = (r * ld + 2 * 2 * TILE * ld + 3 * r * TILE + 2 * r + 2 * TILE) * 4
    assert smem + RESERVED <= SM_SMEM and smem <= BLOCK_SMEM, smem
    assert r * c // THREADS <= 255 // 2


@pytest.mark.parametrize("dh", TA.TC_FWD_DIMS)
def test_tc_fwd_source_declares_a_shape_that_fits_the_sm(dh):
    """Each bf16 tensor-core forward source (``csrc/attention_fwd_tc*.cu``)
    defines its head dim and its shape within its template's checks. Up to
    Dh 256, ``MMU_FWD_TC_SHAPE`` (BT, AREG, MINB) within ``FwdTc``'s in
    ``attention_fwd_tc.cuh``: 32- or 64-key tiles; one block's shared memory
    (q's 128 rows unless AREG, the two-stage K / V ring of 64-column panels,
    the keys' biases, 1 KB of alignment slack) within 227 KB and MINB blocks
    within the SM's 228 KB (1 KB reserved a block); the registers a thread
    holds across a tile (q's A fragments with AREG, 4 a k16 step over Dh,
    O's 64 x Dh accumulators, S and P of a tile) within its share of the
    SM's 64 K registers at MINB blocks of 256 threads, and 255. At Dh 384 and
    768 the source includes ``attention_fwd_tc_wide.cuh``, whose ``FwdTcWide``
    fixes its layout: 192-column slices of O, Dh / 192 blocks a cluster (at
    most 8, the portable size), 128 query rows a cluster; q's slice, the
    ring's K and V slice tiles, two buffers of one tile's partial scores, the
    keys' biases and the slack within 227 KB, one block an SM; O's 64 x 192
    accumulators and S and P of a tile within 255 registers."""
    import re

    from multimodal_uncertainty_tpu_torch.ops import _build

    text = (_build.CSRC_DIR / f"{TA.fwd_source(torch.bfloat16, dh, False)}.cu").read_text()

    def macro(name):
        found = re.search(rf"^#define {name} (.+)$", text, re.M)
        return tuple(int(x) for x in found.group(1).split(","))

    assert macro("MMU_FWD_TC_DH") == (dh,)
    if '#include "attention_fwd_tc_wide.cuh"' in text:
        wide = (_build.CSRC_DIR / "attention_fwd_tc_wide.cuh").read_text()
        c, rows, bt = (int(re.search(rf"static constexpr int {name} = (\d+);", wide).group(1))
                       for name in ("C", "kRows", "BT"))
        n = dh // c
        assert dh in (384, 768) and n * c == dh and n <= 8 and c % 64 == 0 and bt in (32, 64)
        smem = 1024 + c // 64 * rows * 128 + 2 * 2 * c // 64 * bt * 128 + 2 * rows * bt * 4
        smem += 2 * bt * 4
        assert smem <= BLOCK_SMEM and smem + RESERVED <= SM_SMEM, smem
        regs = 64 * c // 128 + 64 * bt // 128 + bt // 4
        assert regs <= 255, regs
        return
    bt, areg, minb = macro("MMU_FWD_TC_SHAPE")
    assert bt in (32, 64) and areg in (0, 1) and minb >= 1
    panels = (dh + 63) // 64
    q_tile = 0 if areg else panels * 128 * 128
    smem = 1024 + q_tile + 2 * 2 * panels * bt * 128 + 2 * bt * 4
    assert smem <= BLOCK_SMEM and minb * (smem + RESERVED) <= SM_SMEM, smem
    regs = (4 * -(-dh // 16) if areg else 0) + 64 * dh // 128 + 64 * bt // 128 + bt // 4
    assert regs <= min(255, 65536 // (THREADS * minb)), regs


@pytest.mark.parametrize("dh", sorted(set(TA.TC_FWD_DIMS) | set(TA.TC_BWD_DIMS)))
def test_tc_scale_of_is_one_over_sqrt_dh_rounded_as_the_plain_version_rounds_it(dh):
    """``scale_of<DH>()`` in ``csrc/attention_tc.cuh``, which both tensor-core
    templates read, holds for every head dim they are built at the fp32
    constant that ``1.0 / dh**0.5`` (the plain versions' scale) rounds to,
    and its static_assert admits exactly those head dims. A mistyped constant
    would otherwise show only on the card, as a 2e-2 miss."""
    import re

    from multimodal_uncertainty_tpu_torch.ops import _build

    text = (_build.CSRC_DIR / "attention_tc.cuh").read_text()
    body = re.search(r"constexpr float scale_of\(\) \{(.*?)\n\}", text, re.S).group(1)
    constants = {int(d): v for d, v in re.findall(r"DH == (\d+)\s*\?\s*([0-9.e+-]+)f", body)}
    admitted = {int(d) for d in re.findall(
        r"DH == (\d+)", re.search(r"static_assert\((.*?),\s*\"", body, re.S).group(1))}
    dims = set(TA.TC_FWD_DIMS) | set(TA.TC_BWD_DIMS)
    assert set(constants) == admitted == dims
    assert np.float32(constants[dh]) == np.float32(1.0 / dh**0.5), (dh, constants[dh])


@pytest.mark.parametrize("c", [8, 24, 32, 48, 64, 96, 128, 192, 256])
def test_tile_rows_are_distinct_and_their_chunks_spread_over_the_banks(c):
    """``at``: every (row, chunk) of a 64-row tile of C-float rows has its own
    16-byte slot inside the tile's 64 x pitch floats, and 8 neighbouring rows'
    same chunk lands in 8 distinct bank slots."""
    ld = _pitch(c)
    offs = [_at(c, row, ch) for row in range(64) for ch in range(c // 4)]
    assert len(set(offs)) == len(offs) and all(o % 4 == 0 and o + 4 <= 64 * ld for o in offs)
    for row0 in range(0, 64, 8):
        for ch in range(c // 4):
            assert len({(_at(c, row, ch) // 4) % 8 for row in range(row0, row0 + 8)}) == 8
