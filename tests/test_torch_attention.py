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


def _inputs(seed: int, s: int):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, s, 3 * D)).astype(np.float32)
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


@pytest.mark.parametrize("dh", [128, 64])
@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
def test_qkv_packed_bf16_matches_jax_bf16(impl, dh):
    qkv, mask = _inputs(3, 40)
    n_head = D // dh
    ref = JA.attention_qkv_packed(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(mask),
                                  n_head=n_head, impl=impl)
    out = TA.attention_qkv_packed(_t(qkv, torch.bfloat16), torch.from_numpy(mask),
                                  n_head=n_head)
    assert out.dtype == torch.bfloat16
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

    path = _build.library_path("attention_fwd")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libattention_fwd-")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("attention_fwd") != path
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
