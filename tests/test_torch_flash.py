"""The port's long-context attention ``attention_flash`` against the JAX
package's, on the CPU.

The JAX side is forced onto its streaming kernels K4
(``_sdpa_flash_fwd_stream_impl``, ``_sdpa_flash_bwd_stream_impl``) in
interpret mode, as ``tests/test_ops.py::test_attention_flash_streaming_past_resident_envelope``
forces it: the resident tile search finds nothing and the streaming tiles are
(128, 128), so every grid dimension has several chunks. On the CPU the port
runs its plain forward and backward (the CUDA kernels run only on the card,
where ``chip_smoke.py`` holds them to the same plain versions at S = 16384).

Inputs and the loss cotangent come from numpy with a seed. Tolerances as the
JAX package's own test: values 2e-5, gradients 3e-5 absolute in fp32 (the
same math summed in another order). Rows keep at least one key, as JAX's
tests do; a fully masked row has its own test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.ops import attention as JA
from multimodal_uncertainty_tpu_torch.ops import attention as TA


@pytest.fixture
def jax_k4(monkeypatch):
    """JAX's flash entry on its streaming kernels K4, (128, 128) tiles."""
    monkeypatch.setattr(JA, "_flash_tiles", lambda *a: None)
    monkeypatch.setattr(JA, "_flash_stream_tiles", lambda *a: (128, 128))
    calls = []
    stream_fwd = JA._sdpa_flash_fwd_stream_impl
    stream_bwd = JA._sdpa_flash_bwd_stream_impl

    def fwd(*a, **kw):
        calls.append("fwd")
        return stream_fwd(*a, **kw)

    def bwd(*a, **kw):
        calls.append("bwd")
        return stream_bwd(*a, **kw)

    monkeypatch.setattr(JA, "_sdpa_flash_fwd_stream_impl", fwd)
    monkeypatch.setattr(JA, "_sdpa_flash_bwd_stream_impl", bwd)
    return calls


def _inputs(b, s, d, seed, fully_masked=()):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, d)).astype(np.float32) for _ in range(3))
    mask = rng.random((b, s)) > 0.3
    mask[:, 0] = True
    for i in fully_masked:
        mask[i] = False
    return q, k, v, mask


def _jax_value_and_grads(q, k, v, mask, h, fn):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, jnp.asarray(mask), n_head=h) ** 2)

    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(t) for t in (q, k, v)))
    return float(val), [np.asarray(g) for g in grads]


def _port_value_and_grads(q, k, v, mask, h):
    ts = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    out = TA.attention_flash(*ts, torch.from_numpy(mask), n_head=h)
    loss = out.square().sum()
    loss.backward()
    return float(loss.detach()), out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("h,dh,s", [(2, 64, 512), (1, 256, 512), (2, 64, 200)])
def test_attention_flash_matches_jax_k4(jax_k4, h, dh, s):
    """Values and gradients against JAX's K4 at both heads-last layouts
    (lane-masked sub-heads at Dh=64, one head a block at Dh=256), four
    chunks in every grid dimension at S=512, and a ragged S=200, which JAX
    pads to 256 and the port takes as it is."""
    b, d = 2, h * dh
    q, k, v, mask = _inputs(b, s, d, seed=15 + s + dh)
    ref_out = np.asarray(JA.attention_flash(*(jnp.asarray(t) for t in (q, k, v)),
                                            jnp.asarray(mask), n_head=h, interpret=True))
    ref_val, ref_grads = _jax_value_and_grads(
        q, k, v, mask, h, lambda *a, **kw: JA.attention_flash(*a, **kw, interpret=True))
    assert jax_k4.count("fwd") >= 2 and "bwd" in jax_k4  # JAX really ran K4
    val, out, grads = _port_value_and_grads(q, k, v, mask, h)
    assert out.shape == (b, s, d)
    np.testing.assert_allclose(out, ref_out, atol=2e-5, rtol=0)
    np.testing.assert_allclose(val, ref_val, rtol=1e-5)
    for name, got, want in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=0, err_msg=f"d{name}")


def test_attention_flash_is_the_heads_last_function():
    """On the CPU the entry runs the plain forward and backward behind the
    same autograd Function as ``attention_heads_last``, so the two agree
    exactly, and the result keeps the input dtype (bf16 here)."""
    q, k, v, mask = _inputs(2, 96, 128, seed=3)
    ts = [torch.tensor(t).bfloat16().requires_grad_() for t in (q, k, v)]
    out = TA.attention_flash(*ts, torch.from_numpy(mask), n_head=2)
    assert out.dtype == torch.bfloat16 and type(out.grad_fn).__name__ == "_AttentionBackward"
    ref = TA.attention_heads_last(*(t.detach() for t in ts), torch.from_numpy(mask), n_head=2)
    torch.testing.assert_close(out.detach(), ref, atol=0, rtol=0)


@pytest.mark.parametrize("h,d", [(2, 192), (1, 96), (4, 160)])
def test_attention_flash_refuses_what_jax_refuses(h, d):
    """A head dim that is neither a multiple nor a divisor of 128 (96, 40)
    has no heads-last flash layout: JAX raises ValueError, and so does the
    port, before any work."""
    q = np.zeros((1, 128, d), np.float32)
    with pytest.raises(ValueError, match="head_dim"):
        JA.attention_flash(*(jnp.asarray(q),) * 3, n_head=h, interpret=True)
    with pytest.raises(ValueError, match="head dim"):
        TA.attention_flash(*(torch.from_numpy(q),) * 3, n_head=h)


def test_attention_flash_refuses_a_head_dim_without_a_kernel_on_the_card():
    """Dh=512 passes JAX's layout rule but the card has no instance of it:
    the kernel route's check (the one the CLIs call before any data loads)
    refuses it for the card, and the plain CPU route takes it."""
    assert 512 not in TA.KERNEL_HEAD_DIMS["attention_fwd_cuda"]
    with pytest.raises(ValueError, match="no kernel on the card"):
        TA.check_kernel_heads(512, 1, "cuda")
    TA.check_kernel_heads(512, 1, "cpu")
    q = torch.zeros(1, 128, 512)
    assert TA.attention_flash(q, q, q, n_head=1).shape == (1, 128, 512)


def test_fully_masked_row_is_the_uniform_average_not_jax_k4s_zeros(jax_k4):
    """A sample whose keys are all masked: the port averages V uniformly
    over all S keys and differentiates that average (the JAX package's K1
    and XLA do the same), where JAX's K4 returns 0 and a zero gradient (a
    kept difference). The sample with kept keys agrees with K4."""
    b, s, h, dh = 2, 256, 2, 64
    q, k, v, mask = _inputs(b, s, h * dh, seed=9, fully_masked=(1,))
    g = np.random.default_rng(10).normal(size=(b, s, h * dh)).astype(np.float32)

    def jax_vjp(fn):
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, jnp.asarray(mask), n_head=h),
                           *(jnp.asarray(t) for t in (q, k, v)))
        return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(g))]

    k4_out, k4_grads = jax_vjp(lambda *a, **kw: JA.attention_flash(*a, **kw, interpret=True))
    xla_out, xla_grads = jax_vjp(lambda *a, **kw: JA.attention_heads_last(*a, **kw, impl="xla"))
    ts = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    out = TA.attention_flash(*ts, torch.from_numpy(mask), n_head=h)
    out.backward(torch.from_numpy(g))
    grads = [t.grad.numpy() for t in ts]

    uniform = v[1].reshape(s, h, dh).mean(axis=0).reshape(1, h * dh)
    np.testing.assert_allclose(out[1].detach().numpy(), np.broadcast_to(uniform, (s, h * dh)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.detach().numpy(), xla_out, atol=2e-5, rtol=0)
    for got, want in zip(grads, xla_grads):
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)
    assert np.abs(xla_grads[2][1]).max() > 0.05  # a real gradient on the masked sample
    assert np.all(k4_out[1] == 0.0) and all(np.all(t[1] == 0.0) for t in k4_grads)
    np.testing.assert_allclose(out[0].detach().numpy(), k4_out[0], atol=2e-5, rtol=0)
    for got, want in zip(grads, k4_grads):
        np.testing.assert_allclose(got[0], want[0], atol=3e-5, rtol=0)
