"""The port's FlavaFusionTransformer against the JAX package's, on the CPU.

The JAX model is initialised from a key; its params cross over through
``fusion_state_dict_from_jax``; both sides get the same numpy inputs and
keep-masks. Tolerance 1e-4 on the (B, E, C) logits: fp32 through 2 layers of
matmuls summed in another order.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.models.fusion import FlavaFusionTransformer as JaxFusion
from multimodal_uncertainty_tpu_torch.models.fusion import (
    FlavaFusionTransformer,
    flava_fusion_with_cls_token,
)
from multimodal_uncertainty_tpu_torch.models.jax_import import fusion_state_dict_from_jax

B, L_IMG, L_TXT = 3, 24, 16
WIDTHS = dict(
    num_classes=5, image_hidden_size=64, text_hidden_size=48,
    multimodal_hidden_size=256, multimodal_num_attention_heads=2,
    multimodal_num_hidden_layers=2,
)
CONFIGS = {
    "vanilla": dict(out_dim=1),
    "mimo": dict(out_dim=2),
    "cls_token": dict(out_dim=2, cls_token=True),
    "avg_pool": dict(out_dim=2, avg_pool=True),
}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, L_IMG, 64)).astype(np.float32)
    txt = rng.normal(size=(B, L_TXT, 48)).astype(np.float32)
    il = np.arange(L_IMG)[None] < rng.integers(L_IMG // 2, L_IMG + 1, size=B)[:, None]
    tl = np.arange(L_TXT)[None] < rng.integers(2, L_TXT + 1, size=B)[:, None]
    return img, txt, il, tl


def _masks(kind, il, tl):
    if kind == "none":
        return None, None
    if kind == "image_ablated":
        return np.zeros_like(il), tl
    return il, np.zeros_like(tl)  # text_ablated


@functools.lru_cache(maxsize=None)
def _pair(config: str, attn_impl: str = "xla"):
    kw = {**WIDTHS, **CONFIGS[config]}
    jmodel = JaxFusion(attn_impl=attn_impl, **kw)
    img, txt, _, _ = _inputs()
    variables = jmodel.init({"params": jax.random.key(7)}, (img, txt), train=False)
    tmodel = FlavaFusionTransformer(**kw).eval()
    tmodel.load_state_dict(fusion_state_dict_from_jax(variables["params"]), strict=True)
    return jmodel, variables, tmodel


def _compare(config, kind, attn_impl="xla"):
    jmodel, variables, tmodel = _pair(config, attn_impl)
    img, txt, il, tl = _inputs(1)
    im, tm = _masks(kind, il, tl)
    ref = jmodel.apply(
        variables, (jnp.asarray(img), jnp.asarray(txt)), train=False,
        img_mask=None if im is None else jnp.asarray(im),
        txt_mask=None if tm is None else jnp.asarray(tm),
    )
    with torch.inference_mode():
        out = tmodel(
            (torch.from_numpy(img), torch.from_numpy(txt)),
            img_mask=None if im is None else torch.from_numpy(im),
            txt_mask=None if tm is None else torch.from_numpy(tm),
        )
    assert out.shape == (B, CONFIGS[config]["out_dim"], WIDTHS["num_classes"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["none", "image_ablated", "text_ablated"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_fusion_logits_match_jax(config, kind):
    _compare(config, kind)


def test_fusion_matches_jax_pallas_kernel_path():
    """The JAX side through its packed Pallas kernel (interpret mode)."""
    _compare("mimo", "image_ablated", attn_impl="pallas_interpret")


def test_state_dict_conversion_layouts():
    _, variables, tmodel = _pair("cls_token")
    params = variables["params"]
    sd = tmodel.state_dict()
    np.testing.assert_array_equal(
        sd["mm_encoder.resblocks.1.attn.in_proj.weight"].numpy(),
        np.asarray(params["mm_encoder"]["resblocks_1"]["attn"]["in_proj"]["kernel"]).T,
    )
    assert sd["output_layers.kernel"].shape == (2, 256, 5)  # (E, D, C) kept
    assert sd["class_embeddings"].shape == (256, 2)  # (D, E) kept


def test_cls_token_constructor():
    m = flava_fusion_with_cls_token(**{**WIDTHS, "out_dim": 2})
    assert m.cls_token and m.class_embeddings.shape == (256, 2)
    assert m.mm_encoder.resblocks[0].dropout.p == 0.1


def test_missing_modality_forward():
    """Image-only input (text None): avg_pool repeats the image pool for the
    second head, as in the JAX model."""
    jmodel, variables, tmodel = _pair("avg_pool")
    img, _, _, _ = _inputs(2)
    ref = jmodel.apply(variables, (jnp.asarray(img), None), train=False)
    with torch.inference_mode():
        out = tmodel((torch.from_numpy(img), None))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
