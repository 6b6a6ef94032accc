"""The port's int8 serving (``ops/quant.py``, ``Linear.quantize``, the
predictors' ``quantize=``) on the CPU, held to the JAX package's
``ops/quant.py`` and its predictors on the same numpy inputs.

The int8 operands equal JAX's; the products agree within 1e-6 x max|ref|
(the CPU's integer product is exact on both sides, the rescale the same fp32
operations). Each family's quantized predictor is within 1e-3 of JAX's under
the same mode (a rounding tie can move one int8 step) and within the JAX
test's bounds of the port's own fp32 answers (max |dp| 0.05 for int8, 0.02
for int8_weight; argmax agreement at least 2/3, ``tests/test_quant.py:89-105``).

The pairs of predictors built here serve ``test_torch_export.py`` too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.ops import quant as JQ
from multimodal_uncertainty_tpu.training.checkpoint import save_weights as jax_save_weights
from multimodal_uncertainty_tpu_torch.models import layers as L
from multimodal_uncertainty_tpu_torch.ops import quant as Q
from multimodal_uncertainty_tpu_torch.training.checkpoint import save_weights

FUSION = dict(out_dim=2, num_classes=3, image_hidden_size=64, text_hidden_size=48,
              multimodal_hidden_size=256, multimodal_num_attention_heads=2,
              multimodal_num_hidden_layers=2)
BERT = dict(vocab_size=128, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=256, max_position_embeddings=128)
MMBT_CLASSES, RESNET, MMBT_IMG = 4, (1, 1, 1, 1), 64
VILT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128,
            num_labels=4, image_size=384)
TOLS = {"int8": 0.05, "int8_weight": 0.02}


# ---------------------------------------------------------------------------
# the JAX and the port's predictors of each family over the same weights
# ---------------------------------------------------------------------------


def fusion_batch(seed, n=3, li=10, lt=7):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(n, li, FUSION["image_hidden_size"])).astype(np.float32)
    txt = rng.normal(size=(n, lt, FUSION["text_hidden_size"])).astype(np.float32)
    return img, txt, rng.integers(1, li + 1, size=n), rng.integers(1, lt + 1, size=n)


def mmbt_batch(seed, n=3, lt=24):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(6, lt + 1, size=n)
    mask = (np.arange(lt)[None] < lengths[:, None]).astype(np.int64)
    txt = rng.integers(0, BERT["vocab_size"], size=(n, lt)) * mask
    seg = rng.integers(0, 2, size=(n, lt)) * mask
    img = rng.normal(size=(n, MMBT_IMG, MMBT_IMG, 3)).astype(np.float32)
    return txt, mask, seg, img


def vilt_batch(seed, n=3, lt=16):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, lt + 1, size=n)
    am = (np.arange(lt)[None] < lengths[:, None]).astype(np.int64)
    pm = np.zeros((n, 384, 384), np.int64)
    pm[:, :256, :320] = 1
    pm[0] = 1
    return {"input_ids": rng.integers(104, 30522, size=(n, lt)) * am, "attention_mask": am,
            "token_type_ids": np.zeros((n, lt), np.int64),
            "pixel_values": rng.normal(size=(n, 384, 384, 3)).astype(np.float32),
            "pixel_mask": pm}


def _random_variables(init, seed: int):
    """Variables of ``init``'s tree drawn in numpy from ``seed``, at the scale
    of the models' initialisers (``jax.eval_shape`` traces the init without
    running it, which at MMBT's ResNet would take most of the file's time):
    kernels U(-1, 1) / sqrt(fan in), norm scales and running variances about
    1, embeddings and the rest N(0, 0.02)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key, shape = path[-1].key, leaf.shape
        if key == "kernel":
            fan_in = shape[-2] if len(shape) == 3 else int(np.prod(shape[:-1]))
            a = rng.uniform(-1.0, 1.0, shape) / np.sqrt(fan_in)
        elif key in ("weight", "scale", "ln_weight", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.normal(0.0, 0.02, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init))


def _jax_fusion(tmp):
    from multimodal_uncertainty_tpu.models.fusion import FlavaFusionTransformer as JaxFusion
    from multimodal_uncertainty_tpu_torch.models.jax_import import fusion_state_dict_from_jax

    jmodel = JaxFusion(attn_impl="xla", **FUSION)
    img, txt, _, _ = fusion_batch(0, n=2)
    variables = _random_variables(
        lambda: jmodel.init({"params": jax.random.key(3)}, (img, txt), train=False), 3)
    return jmodel, variables, fusion_state_dict_from_jax(variables["params"])


def _jax_mmbt(tmp):
    from multimodal_uncertainty_tpu.models import bert as JB
    from multimodal_uncertainty_tpu.models.mmbt import MultimodalBertClf as JaxMMBT
    from multimodal_uncertainty_tpu_torch.models.jax_import import mmbt_state_dict_from_jax

    jmodel = JaxMMBT(config=JB.BertConfig(**BERT), n_classes=MMBT_CLASSES, num_image_embeds=3,
                     resnet_layers=RESNET, attn_impl="xla")
    x = tuple(jnp.asarray(a) for a in mmbt_batch(0, n=2))
    variables = _random_variables(
        lambda: jmodel.init({"params": jax.random.key(0)}, x, train=False), 0)
    return jmodel, variables, mmbt_state_dict_from_jax(variables)


def _jax_vilt(tmp):
    from multimodal_uncertainty_tpu.models.vilt import ViltConfig as JaxConfig
    from multimodal_uncertainty_tpu.models.vilt import (
        ViltForImagesAndTextClassification as JaxVilt,
    )
    from multimodal_uncertainty_tpu_torch.models.jax_import import vilt_state_dict_from_jax

    jmodel = JaxVilt(config=dataclasses.replace(JaxConfig.b32(), **VILT), attn_impl="xla")
    sample = {k: jnp.asarray(v) for k, v in vilt_batch(0, n=2).items()}
    variables = _random_variables(
        lambda: jmodel.init({"params": jax.random.key(0)}, sample, train=False), 0)
    return jmodel, variables, vilt_state_dict_from_jax(variables)


def port_model(family):
    from multimodal_uncertainty_tpu_torch.models import bert as TB
    from multimodal_uncertainty_tpu_torch.models.fusion import FlavaFusionTransformer
    from multimodal_uncertainty_tpu_torch.models.mmbt import MultimodalBertClf
    from multimodal_uncertainty_tpu_torch.models.vilt import ViltConfig
    from multimodal_uncertainty_tpu_torch.zoo import build_vilt

    if family == "flava":
        return FlavaFusionTransformer(**FUSION)
    if family == "mmbt":
        return MultimodalBertClf(TB.BertConfig(**BERT), MMBT_CLASSES, resnet_layers=RESNET,
                                 generator=torch.Generator().manual_seed(5))
    return build_vilt(VILT["num_labels"], vilt_config=dataclasses.replace(ViltConfig.b32(), **VILT),
                      device="cpu", generator=torch.Generator().manual_seed(5))


_PREDICTORS = {"flava": ("FusionPredictor", dict(pad_multiple=8, batch_buckets=(4, 8))),
               "mmbt": ("MMBTPredictor", dict(batch_buckets=(4, 8))),
               "vilt": ("ViltPredictor", dict(batch_buckets=(4, 8)))}


def port_predictor(family, ckpt, **kw):
    from multimodal_uncertainty_tpu_torch import serving

    cls, base = _PREDICTORS[family]
    return getattr(serving, cls)(port_model(family), ckpt, device="cpu", **{**base, **kw})


def checkpoints(family, tmp):
    """(JAX model, its variables, the JAX checkpoint, the port's checkpoint) of
    one family's tiny model, the port's weights carried across from JAX's."""
    jmodel, variables, state_dict = {"flava": _jax_fusion, "mmbt": _jax_mmbt,
                                     "vilt": _jax_vilt}[family](tmp)
    jpath, tpath = str(tmp / f"jax_{family}.pt"), str(tmp / f"{family}.pt")
    jax_save_weights(variables, None, jpath, async_write=False)
    save_weights(state_dict, None, tpath)
    return jmodel, variables, jpath, tpath


def jax_predictor(family, ckpts, **kw):
    from multimodal_uncertainty_tpu import serving as JS

    jmodel, variables, jpath, _ = ckpts
    cls, base = _PREDICTORS[family]
    return getattr(JS, cls)(jmodel, jpath, template_variables=variables, **{**base, **kw})


def predict(family, pred, seed, **kw):
    """One batch of ``family``'s inputs through ``pred`` (JAX's or the port's)."""
    if family == "flava":
        img, txt, il, tl = fusion_batch(seed)
        return pred.predict(img, txt, img_lengths=il, txt_lengths=tl, **kw)
    if family == "mmbt":
        return pred.predict(*mmbt_batch(seed), **kw)
    return pred.predict(vilt_batch(seed), **kw)


@pytest.fixture(scope="module", params=["flava", "mmbt", "vilt"])
def family_ckpts(request, tmp_path_factory):
    return request.param, checkpoints(request.param, tmp_path_factory.mktemp(request.param))


# ---------------------------------------------------------------------------
# ops/quant.py against the JAX module
# ---------------------------------------------------------------------------


def _operands(shape=(7, 48), n=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x.reshape(-1, shape[-1])[2] = 0.0  # a zero row: its scale is the 1e-12 floor
    w = (rng.normal(size=(shape[-1], n)) / np.sqrt(shape[-1])).astype(np.float32)  # JAX (in, out)
    return x, w


def test_int8_operands_equal_jax():
    x, w = _operands()
    wq, ws = Q.weight_int8(torch.from_numpy(w.T.copy()))
    jwq, jws = JQ._weight_int8(jnp.asarray(w))
    np.testing.assert_array_equal(wq.numpy().T, np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws)[0])
    xq, xs = Q.activation_int8(torch.from_numpy(x))
    # the JAX package's activation quantization (ops/quant.py:83-86), on the same arrays
    x32 = jnp.asarray(x)
    jxs = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True) / 127.0, 1e-12)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jnp.round(x32 / jxs).astype(jnp.int8)))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    assert xq.dtype == torch.int8 and int(xq[2].abs().max()) == 0


@pytest.mark.parametrize("shape", [(7, 48), (2, 5, 48)])
@pytest.mark.parametrize("mode", ["int8", "int8_weight", None])
def test_quant_dot_matches_jax(mode, shape):
    x, w = _operands(shape)
    got = Q.quant_dot(torch.from_numpy(x), torch.from_numpy(w.T.copy()), mode).numpy()
    ref = np.asarray(JQ.quant_dot(jnp.asarray(x), jnp.asarray(w), mode))
    assert got.shape == ref.shape == shape[:-1] + (40,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    assert np.isfinite(got).all() and (got.reshape(-1, 40)[2] == 0).all()
    if mode is not None:  # the named functions are quant_dot's branches
        fn = Q.int8_dot if mode == "int8" else Q.int8_weight_dot
        jfn = JQ.int8_dot if mode == "int8" else JQ.int8_weight_dot
        np.testing.assert_array_equal(fn(torch.from_numpy(x), torch.from_numpy(w.T.copy())),
                                      got)
        np.testing.assert_allclose(np.asarray(jfn(jnp.asarray(x), jnp.asarray(w))), ref,
                                   rtol=0, atol=0)


def test_int8_mm_plain_is_exact_and_the_operator_takes_it_on_the_cpu():
    rng = np.random.default_rng(3)
    a = rng.integers(-127, 128, size=(19, 3072)).astype(np.int8)
    b = rng.integers(-127, 128, size=(3072, 101)).astype(np.int8)
    a[0] = 127
    b[:, 0] = 127  # the largest sum of products: 3072 x 127^2
    ref = a.astype(np.int64) @ b.astype(np.int64)
    for fn in (Q.int8_mm_plain, Q.int8_mm, torch.ops.mmu.int8_mm):
        got = fn(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="CUDA"):
        Q.int8_mm_cuda(torch.from_numpy(a), torch.from_numpy(b))
    with pytest.raises(ValueError, match="unknown quantization mode"):
        Q.quant_dot(torch.zeros(2, 8), torch.zeros(4, 8), "fp4")


def test_set_quantize_keeps_the_state_dict_and_takes_precedence_over_fast_dw():
    lin = L.Linear(48, 40, generator=torch.Generator().manual_seed(0))
    keys = set(lin.state_dict())
    x = torch.randn(6, 48, generator=torch.Generator().manual_seed(1))
    plain = lin(x)
    L.set_quantize(lin, "int8")
    assert set(lin.state_dict()) == keys and lin.weight_q.dtype == torch.int8
    lin.fast_dw = True  # training mode: the quant branch is taken first, as in JAX
    np.testing.assert_array_equal(
        lin(x).detach(), Q.int8_dot(x, lin.weight.detach()) + lin.bias.detach())
    L.set_quantize(lin, None)
    lin.fast_dw = False
    assert lin.weight_q is None and torch.equal(lin(x), plain)
    with pytest.raises(ValueError):
        L.set_quantize(lin, "int4")


# ---------------------------------------------------------------------------
# the quantized predictors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "int8_weight"])
def test_quantized_predictor_matches_jax_and_stays_near_fp32(family_ckpts, mode, monkeypatch):
    """One family under one mode: the port's quantized predictor against
    JAX's (1e-3), against the port's fp32 answers (the JAX test's bounds), and
    one int8 product a quantized Linear call (counted on the CPU's route)."""
    family, ckpts = family_ckpts
    full = port_predictor(family, ckpts[3])
    quant = port_predictor(family, ckpts[3], quantize=mode, temperature=1.3)
    jquant = jax_predictor(family, ckpts, quantize=mode, temperature=1.3)

    calls, products = [], []
    for m in quant.model.modules():
        if isinstance(m, L.Linear):
            m.register_forward_hook(lambda *_: calls.append(1))
    plain_mm = Q.int8_mm_plain
    monkeypatch.setattr(Q, "int8_mm_plain", lambda a, b: products.append(1) or plain_mm(a, b))
    got = predict(family, quant, 1)
    assert calls and len(products) == (len(calls) if mode == "int8" else 0)

    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, predict(family, jquant, 1), atol=1e-3, rtol=0)
    tempered = port_predictor(family, ckpts[3], temperature=1.3)
    ref = predict(family, tempered, 1)
    assert 0 < np.abs(got - ref).max() < TOLS[mode]
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 2 / 3
    # the fp32 predictor is untouched by another's quantization
    np.testing.assert_array_equal(predict(family, full, 1),
                                  predict(family, port_predictor(family, ckpts[3]), 1))


def test_bench_quant_rows(capsys):
    """``tools/bench_quant.py`` on the CPU at a toy size: its four rows, the
    int8 products counted only on the card (none here), each row's answers
    near fp32's."""
    from multimodal_uncertainty_tpu_torch.tools import bench_quant

    rows = bench_quant.main(["--device", "cpu", "--batch", "2", "--img_len", "9", "--txt_len",
                             "7", "--layers", "1", "--iters", "1"])
    assert [r["row"] for r in rows] == [name for name, _, _ in bench_quant.ROWS]
    assert rows[0]["max_abs_dp_vs_fp32"] == 0.0
    assert all(r["ms"] > 0 and r["int8_products_per_forward"] == 0 and
               r["max_abs_dp_vs_fp32"] < 0.05 for r in rows)
    out = capsys.readouterr().out
    assert out.startswith("card: cpu") and "speedups vs fp32" in out
