"""The port's LayerNorm kernel route against the JAX package's Pallas
LayerNorm (K7), on the CPU.

The JAX side runs ``layer_norm_pallas`` in interpret mode (256-row blocks,
fp32 internals) and the flax ``LayerNormFP32(impl="pallas_interpret")``; the
port runs ``layer_norm_kernel`` and ``LayerNormFP32(impl="kernel")``, which
on a CPU tensor take the plain version (the CUDA kernel runs only on the
card, where ``chip_smoke.py`` holds it to the same plain version). Inputs and
weights come from numpy with a seed and go to both sides. Tolerance 1e-5
absolute in fp32 (the same math summed in another order); in bf16 one
rounding step of the largest output, 2^-7 x max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.models.layers import LayerNormFP32 as JaxLayerNormFP32
from multimodal_uncertainty_tpu.ops.norms import layer_norm_pallas
from multimodal_uncertainty_tpu_torch.models.layers import LayerNormFP32
from multimodal_uncertainty_tpu_torch.ops import norms as TN

# (shape, eps): a small 3-d input; 300 rows, across the Pallas kernel's 256-row block edge;
# ViLT's and BERT's eps 1e-12 at width 768
CASES = [((4, 7, 64), 1e-5), ((300, 768), 1e-5), ((2, 150, 768), 1e-12)]


def _inputs(shape, seed, mean=0.0):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (mean + rng.normal(size=shape)).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    b = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape,eps", CASES)
def test_layer_norm_kernel_matches_jax_pallas(shape, eps):
    x, w, b = _inputs(shape, seed=len(shape) + shape[-1])
    ref = np.asarray(layer_norm_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps,
                                       interpret=True))
    with torch.no_grad():
        got = TN.layer_norm_kernel(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b), eps)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,eps", CASES)
def test_layer_norm_fp32_kernel_impl_matches_the_jax_module(shape, eps):
    """The module with the same weights: ``impl="kernel"`` against JAX's
    ``"pallas_interpret"``, and the default against JAX's ``"xla"``."""
    x, w, b = _inputs(shape, seed=7 + shape[-1])
    params = {"params": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}}
    d = shape[-1]
    for jax_impl, impl in (("pallas_interpret", "kernel"), ("xla", "plain")):
        ref = np.asarray(JaxLayerNormFP32(eps=eps, impl=jax_impl).apply(params, jnp.asarray(x)))
        m = LayerNormFP32(d, eps)
        assert m.impl == "plain"
        m.impl = impl
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(w))
            m.bias.copy_(torch.from_numpy(b))
            got = m(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0, err_msg=impl)


@pytest.mark.parametrize("kind", ["linspace", "normal"])
def test_bf16_with_a_large_mean_runs_fp32_internally(kind):
    """bf16 rows around 300: JAX's own case (300 + linspace(0, 1), which bf16
    rounds to one value a row, so the variance is exactly 0) and rows of
    spread 4. The variance is taken from the centred values, so nothing
    cancels: bf16 out, within one bf16 step of JAX's Pallas kernel and within
    0.05 of the fp32 normalisation of the same bf16 values (JAX's bound)."""
    if kind == "linspace":
        xf = (300.0 + np.linspace(0, 1, 128)[None].repeat(2, axis=0)).astype(np.float32)
    else:
        xf = (300.0 + 4.0 * np.random.default_rng(12).normal(size=(300, 128))).astype(np.float32)
    x = torch.from_numpy(xf).bfloat16()
    x32 = x.float().numpy()  # the bf16 values, exactly
    w = np.ones(128, np.float32)
    b = np.zeros(128, np.float32)
    ref = np.asarray(layer_norm_pallas(jnp.asarray(x32).astype(jnp.bfloat16), jnp.asarray(w),
                                       jnp.asarray(b), interpret=True).astype(jnp.float32))
    with torch.no_grad():
        got = TN.layer_norm_kernel(x, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    f32 = TN.layer_norm(torch.from_numpy(x32), torch.from_numpy(w), torch.from_numpy(b))
    assert bool(torch.isfinite(got.float()).all())
    tol = 2.0 ** -7 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol, rtol=0)
    np.testing.assert_allclose(got.float().numpy(), f32.numpy(), atol=0.05, rtol=0)


def test_layer_norm_kernel_is_forward_only():
    """JAX cannot differentiate ``layer_norm_pallas``; the port's kernel
    route raises where a gradient would be needed (an input or a parameter
    that requires one, under grad mode) instead of taking the plain route.
    Under ``torch.no_grad`` it runs; the plain route keeps its gradient."""
    x, w, b = _inputs((4, 64), seed=1)
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(lambda x: layer_norm_pallas(x, jnp.asarray(w), jnp.asarray(b),
                                             interpret=True).sum())(jnp.asarray(x))
    xt, wt, bt = (torch.from_numpy(t) for t in (x, w, b))
    with pytest.raises(RuntimeError, match="forward only"):
        TN.layer_norm_kernel(xt.clone().requires_grad_(), wt, bt)
    m = LayerNormFP32(64)
    m.impl = "kernel"
    with pytest.raises(RuntimeError, match="forward only"):
        m(xt)  # its weight and bias require a gradient
    with torch.no_grad():
        assert m(xt).shape == (4, 64)
    plain = LayerNormFP32(64)
    plain(xt.clone().requires_grad_()).sum().backward()
    assert plain.weight.grad is not None


def test_kernel_impl_set_on_a_built_fusion_model_keeps_its_answers():
    """The way a caller selects the kernel, as ``chip_smoke.py`` does on the
    FLAVA predictor: every ``LayerNormFP32`` of a built fusion model starts
    on the plain route and, set to ``"kernel"``, gives the same logits under
    ``torch.no_grad`` (on the CPU the kernel route is the plain version)."""
    from multimodal_uncertainty_tpu_torch.zoo import build_flava

    model = build_flava("MIMO-shuffle-instance", n_classes=5, heads=3, layers=1, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    norms = [m for m in model.modules() if isinstance(m, LayerNormFP32)]
    assert len(norms) == 4 and all(m.impl == "plain" for m in norms)
    rng = np.random.default_rng(3)
    x = tuple(torch.from_numpy(rng.normal(size=(2, n, 768)).astype(np.float32)) for n in (8, 4))
    with torch.no_grad():
        ref = model(x)
        for m in norms:
            m.impl = "kernel"
        got = model(x)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


def test_layer_norm_cuda_refuses_a_cpu_tensor():
    """The kernel's wrapper launches on the card or raises: a CPU tensor is
    refused before anything is built."""
    x, w, b = (torch.from_numpy(t) for t in _inputs((4, 64), seed=2))
    launches = TN.layer_norm_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        TN.layer_norm_cuda(x, w, b)
    assert TN.layer_norm_cuda.launches == launches


@pytest.mark.parametrize("d,dtype,ldx,aligned,nv", [
    (768, torch.float32, 768, True, 6), (768, torch.bfloat16, 768, True, 3),
    (768, torch.float32, 320 * 768, True, 6),  # the rows of x[:, 0], read in place
    (128, torch.float32, 128, True, 1), (1024, torch.float32, 1024, True, 8),
    (256, torch.bfloat16, 256, True, 1), (1024, torch.bfloat16, 1024, True, 4),
    (64, torch.float32, 64, True, 0),  # less than a float4 a lane: the CPU tests' width
    (128, torch.bfloat16, 128, True, 0), (100, torch.bfloat16, 100, True, 0),  # odd D
    (1152, torch.float32, 1152, True, 0), (2048, torch.bfloat16, 2048, True, 0),  # past 32 a lane
    (768, torch.float32, 770, True, 0), (768, torch.bfloat16, 772, True, 0),  # stride
    (768, torch.float32, 768, False, 0), (768, torch.bfloat16, 768, False, 0),  # alignment
])
def test_layer_norm_cuda_picks_its_instance_by_shape(d, dtype, ldx, aligned, nv):
    """K7's instance: the row held in registers, ``nv`` 16-byte vectors a lane
    (D = 32 x nv x 4 in fp32, x 8 in bf16, up to 32 elements a lane), where D,
    the row stride and the pointers allow; else 0, the generic instance."""
    assert TN.ln_instance(d, dtype, ldx, aligned) == nv
