"""The port's BERT attention backward (K2 bwd) and attention-probability
dropout (K5 fwd and bwd) against the JAX package's, on the CPU.

Inputs, cotangents and MMBT's key masks are drawn with numpy from a seed and
handed to both sides. The JAX side draws its keep mask from a key
(``jax.random.bernoulli(key, 1 - rate, (B, H, S, S))``, the draw its K5 route
and its XLA route both make); the port is handed that same mask through
``attention_heads_last_dropout_keep``. On the CPU the port runs its plain
versions (the CUDA kernels run only on the card, where ``chip_smoke.py``
holds them against the same plain versions). The JAX side runs its Pallas
kernels in interpret mode (``impl="pallas_interpret"``) and its XLA path.

Tolerance 1e-5 absolute in fp32: the same math summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.ops import attention as JA
from multimodal_uncertainty_tpu_torch.ops import attention as TA

B, N_IMG, L = 4, 5, 40
S, D, N_HEAD = N_IMG + L, 128, 2  # two heads of Dh=64, as BERT's
TOL = 1e-5


def _mmbt_mask(rng) -> np.ndarray:
    """MMBT's key masks over 5 image tokens + text: ragged text, image
    ablated (the image [CLS] and the text kept), text ablated (the image
    segment only), and a batch-padding row (the image segment only)."""
    m = np.zeros((B, S), bool)
    m[:, :N_IMG] = True
    m[0, N_IMG:] = True
    m[1, N_IMG:N_IMG + int(rng.integers(1, L))] = True
    m[1, 1:N_IMG] = False
    m[3, N_IMG:N_IMG + 7] = True
    return m  # row 2: text ablated / a batch-padding row


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, S, D)).astype(np.float32) for _ in range(4))
    return q, k, v, g, _mmbt_mask(rng)


def _t(x, requires_grad=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=requires_grad)


def _port_grads(fn, q, k, v, g):
    """(out, (dq, dk, dv)) of the port's ``fn(q, k, v)`` under cotangent g."""
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    out = fn(qt, kt, vt)
    out.backward(_t(g))
    return out.detach().numpy(), (qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy())


def _jax_grads(fn, q, k, v, g):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), tuple(np.asarray(t) for t in vjp(jnp.asarray(g)))


def _close(port, ref):
    out, grads = port
    ref_out, ref_grads = ref
    np.testing.assert_allclose(out, ref_out, atol=TOL, rtol=0, err_msg="out")
    for name, got, want in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=f"d{name}")


# ---------------------------------------------------------------- K2 bwd


@pytest.mark.parametrize("route", ["k2", "xla"])
def test_heads_last_grads_match_jax(route, monkeypatch):
    """dq, dk, dv of ``attention_heads_last`` (BERT's separate q, k, v, Dh=64,
    MMBT's masks) equal JAX K2's custom VJP in interpret mode, and XLA's."""
    q, k, v, g, mask = _inputs(1)
    calls = []
    if route == "k2":
        real = JA._sdpa_pallas_hl
        monkeypatch.setattr(JA, "_sdpa_pallas_hl",
                            lambda *a, **kw: calls.append(1) or real(*a, **kw))
    impl = "pallas_interpret" if route == "k2" else "xla"
    ref = _jax_grads(lambda a, b, c: JA.attention_heads_last(
        a, b, c, jnp.asarray(mask), n_head=N_HEAD, impl=impl), q, k, v, g)
    assert len(calls) == (1 if route == "k2" else 0)  # the JAX route under test was taken
    port = _port_grads(lambda a, b, c: TA.attention_heads_last(
        a, b, c, torch.from_numpy(mask), n_head=N_HEAD), q, k, v, g)
    _close(port, ref)


# ---------------------------------------------------------------- K5


def _jax_keep(key, rate):
    return np.asarray(jax.random.bernoulli(key, 1.0 - rate, (B, N_HEAD, S, S)))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_matches_jax_k5_kernel(rate, monkeypatch):
    """Forward and gradients of the port's dropout attention, handed the mask
    JAX drew, equal JAX K5 (``_sdpa_pallas_hl_drop``, interpret mode)."""
    q, k, v, g, mask = _inputs(2)
    key = jax.random.key(7)
    calls = []
    real = JA._sdpa_pallas_hl_drop
    monkeypatch.setattr(JA, "_sdpa_pallas_hl_drop",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ref = _jax_grads(lambda a, b, c: JA.attention_heads_last_dropout(
        a, b, c, jnp.asarray(mask), n_head=N_HEAD, rate=rate, rng=key,
        impl="pallas_interpret"), q, k, v, g)
    assert len(calls) == 1  # K5 served the shape
    keep = torch.from_numpy(_jax_keep(key, rate).astype(np.uint8))
    port = _port_grads(lambda a, b, c: TA.attention_heads_last_dropout_keep(
        a, b, c, torch.from_numpy(mask), keep, n_head=N_HEAD, rate=rate), q, k, v, g)
    _close(port, ref)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_matches_jax_xla_route(rate):
    """The JAX package's XLA ``attention_probs_dropout`` (the route it takes
    where K5's whole sequence does not fit) under autodiff, from the same
    key: the port's plain forward and its gradients equal it."""
    q, k, v, g, mask = _inputs(3)
    key = jax.random.key(8)
    ref = _jax_grads(lambda a, b, c: JA.attention_probs_dropout(
        a, b, c, jnp.asarray(mask), n_head=N_HEAD, rate=rate, rng=key), q, k, v, g)
    keep = torch.from_numpy(_jax_keep(key, rate).astype(np.uint8))
    port = _port_grads(lambda a, b, c: TA.attention_heads_last_dropout_keep(
        a, b, c, torch.from_numpy(mask), keep, n_head=N_HEAD, rate=rate), q, k, v, g)
    _close(port, ref)
    np.testing.assert_allclose(
        TA.attention_probs_dropout(_t(q), _t(k), _t(v), torch.from_numpy(mask), n_head=N_HEAD,
                                   rate=rate, keep=keep).numpy(), ref[0], atol=TOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_bwd_plain_matches_autograd_of_the_plain_forward(dtype):
    """In fp32 the plain dropout backward is autograd of the plain forward;
    in bf16 it rounds Pd and dS as the JAX kernel does, which autograd does
    not, so the two agree to a bf16 rounding of the gradient (3e-2 x max)."""
    q, k, v, g, mask = _inputs(4)
    rate = 0.3
    keep = TA.draw_keep_mask((B, N_HEAD, S, S), rate, generator=torch.Generator().manual_seed(0))
    ins = [_t(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = TA.attention_probs_dropout(*ins, torch.from_numpy(mask), n_head=N_HEAD, rate=rate,
                                     keep=keep)
    out.backward(_t(g).to(dtype))
    grads = TA.attention_bwd_dropout_plain(*(t.detach() for t in ins), torch.from_numpy(mask),
                                           keep, _t(g).to(dtype), n_head=N_HEAD, rate=rate)
    for name, got, ref in zip("qkv", grads, ins):
        assert got.dtype == dtype
        tol = TOL if dtype == torch.float32 else 3e-2 * max(1.0, float(ref.grad.float().abs().max()))
        torch.testing.assert_close(got.float(), ref.grad.float(), atol=tol, rtol=0,
                                   msg=f"d{name}")


def test_keep_mask_draw_is_a_function_of_the_generator():
    shape = (2, 3, 50, 50)
    a = TA.draw_keep_mask(shape, 0.1, generator=torch.Generator().manual_seed(3))
    b = TA.draw_keep_mask(shape, 0.1, generator=torch.Generator().manual_seed(3))
    c = TA.draw_keep_mask(shape, 0.1, generator=torch.Generator().manual_seed(4))
    assert a.dtype == torch.uint8 and a.shape == shape and a.is_contiguous()
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.float().mean()) - 0.9) < 0.01  # P(keep) = 1 - rate
    assert set(a.unique().tolist()) == {0, 1}


def test_rate_zero_is_attention_heads_last_and_rate_positive_runs_the_function():
    q, k, v = (torch.randn(2, 9, 128, requires_grad=True) for _ in range(3))
    out = TA.attention_heads_last_dropout(q, k, v, n_head=2, rate=0.0)
    assert type(out.grad_fn).__name__ == "_AttentionBackward"
    torch.testing.assert_close(out, TA.attention_heads_last(q, k, v, n_head=2), atol=0, rtol=0)
    gen = torch.Generator().manual_seed(5)
    out = TA.attention_heads_last_dropout(q, k, v, n_head=2, rate=0.2, generator=gen)
    assert type(out.grad_fn).__name__ == "_DropoutAttentionBackward"
    out.sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in (q, k, v))
    again = TA.attention_heads_last_dropout(q, k, v, n_head=2, rate=0.2,
                                            generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(again, out.detach(), atol=0, rtol=0)  # same seed, same mask


def test_dropout_wrappers_reject_what_they_cannot_take():
    q = torch.zeros(1, 4, 128)
    keep = torch.ones(1, 2, 4, 4, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        TA.attention_fwd_dropout_cuda(q, q, q, None, keep, n_head=2, rate=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        TA.attention_bwd_dropout_cuda(q, q, q, None, keep, q, torch.zeros(1, 2, 4), q,
                                      n_head=2, rate=0.1)
    with pytest.raises(ValueError, match="keep mask"):
        TA.attention_probs_dropout(q, q, q, n_head=2, rate=0.1)
    with pytest.raises(ValueError, match="divisible"):
        TA.attention_heads_last_dropout_keep(q, q, q, None, keep, n_head=3, rate=0.1)
    with pytest.raises(ValueError, match="in \\(0, 1\\)"):
        TA._check_keep(keep, 1.0, 1, 2, 4, q.device)
    with pytest.raises(ValueError, match="uint8"):
        TA._check_keep(keep.bool(), 0.1, 1, 2, 4, q.device)
    assert TA.KERNEL_HEAD_DIMS["attention_fwd_dropout_cuda"] == (32, 64)
    assert TA.KERNEL_HEAD_DIMS["attention_bwd_dropout_cuda"] == (32, 64)
