"""The port's MMBT (BERT + ResNet) against the JAX package's, on the CPU.

Weights come from the JAX model's init, with every BatchNorm's scale, bias
and running statistics redrawn from a numpy seed so the BatchNorm conversion
is exercised, and cross over through ``mmbt_state_dict_from_jax``. Both sides
get the same numpy inputs and keep masks. The JAX side runs its XLA
attention, its K2 Pallas kernel in interpret mode (``pallas_interpret``) and,
with the whole-sequence budget forced to 1 byte, its K3 flash kernels; the
port runs its plain attention (the CUDA kernel runs only on the card).

Tolerances: 1e-5 on attention outputs (the same math summed in another
order); 1e-4 on logits (fp32 through a ResNet and 2 BERT layers); ResNet
features, whose scale grows block by block, to 1e-5 relative to their max.
``JAX_PLATFORMS=cpu python -m tests.test_torch_mmbt`` prints the measured
maxima of the whole-model comparison.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.models import bert as JB
from multimodal_uncertainty_tpu.models import resnet_tv as JR
from multimodal_uncertainty_tpu.models.mmbt import MultimodalBertClf as JaxMMBT
from multimodal_uncertainty_tpu.models.mmbt import MultimodalBertEncoder as JaxEncoder
from multimodal_uncertainty_tpu.ops import attention as JA
from multimodal_uncertainty_tpu_torch.models import bert as TB
from multimodal_uncertainty_tpu_torch.models import resnet_tv as TR
from multimodal_uncertainty_tpu_torch.models.jax_import import mmbt_state_dict_from_jax
from multimodal_uncertainty_tpu_torch.models.mmbt import MultimodalBertClf
from multimodal_uncertainty_tpu_torch.ops import attention as TA

BERT = dict(vocab_size=128, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=256, max_position_embeddings=128)
N_CLASSES, RESNET, IMG = 5, (1, 1, 1, 1), 64
B, L = 4, 40  # text of 6-40 tokens; row 3 is a batch-padding row (text mask 0)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _redraw_batchnorm(variables, seed):
    """Random BatchNorm scale / bias / mean / var (the init's are 1, 0, 0, 1)."""
    rng = np.random.default_rng(seed)
    params, stats = _numpy_tree(variables["params"]), _numpy_tree(variables["batch_stats"])

    def walk(p, s):
        for key in s:
            if key == "bn":
                c = s["bn"]["mean"].shape
                p["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                p["bn"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                s["bn"]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                s["bn"]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            else:
                walk(p[key], s[key])

    walk(params, stats)
    return {"params": params, "batch_stats": stats}


def _inputs(seed=0, n=B, lt=L):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(6, lt + 1, size=n)
    lengths[0] = lt
    mask = (np.arange(lt)[None] < lengths[:, None]).astype(np.int32)
    mask[-1] = 0  # a row added to reach the batch bucket
    txt = (rng.integers(0, BERT["vocab_size"], size=(n, lt)) * mask).astype(np.int32)
    seg = (rng.integers(0, 2, size=(n, lt)) * mask).astype(np.int32)
    img = rng.normal(size=(n, IMG, IMG, 3)).astype(np.float32)
    return txt, mask, seg, img


def _torch(x):
    return tuple(torch.from_numpy(np.asarray(a)).long() if a.dtype != np.float32
                 else torch.from_numpy(a) for a in x)


@functools.lru_cache(maxsize=None)
def _pair(num_image_embeds=3):
    """(JAX variables, port model) with the same weights."""
    jmodel = JaxMMBT(config=JB.BertConfig(**BERT), n_classes=N_CLASSES,
                     num_image_embeds=num_image_embeds, resnet_layers=RESNET, attn_impl="xla")
    x = tuple(jnp.asarray(a) for a in _inputs(0))
    variables = _redraw_batchnorm(jmodel.init({"params": jax.random.key(1)}, x, train=False),
                                  seed=num_image_embeds)
    tmodel = MultimodalBertClf(TB.BertConfig(**BERT), N_CLASSES, num_image_embeds,
                               resnet_layers=RESNET).eval()
    tmodel.load_state_dict(mmbt_state_dict_from_jax(variables), strict=True)
    return variables, tmodel


def _jax_mmbt(attn_impl, num_image_embeds=3):
    return JaxMMBT(config=JB.BertConfig(**BERT), n_classes=N_CLASSES,
                   num_image_embeds=num_image_embeds, resnet_layers=RESNET, attn_impl=attn_impl)


# ---------------------------------------------------------------------------
# attention_heads_last (K2 fwd; K3 fwd past the whole-sequence budget)
# ---------------------------------------------------------------------------


def _mmbt_key_masks(s, rng):
    """Masks of MMBT batches over 5 image tokens + text: ragged text, image
    ablated (the image [CLS] and the text kept), text ablated (the image
    segment only), and a batch-padding row (the image segment only)."""
    n_img = 5
    m = np.zeros((4, s), bool)
    m[:, :n_img] = True
    for i, length in enumerate((s - n_img, 7, 11)):
        m[i, n_img:n_img + length] = True
    m[1, 1:n_img] = False
    m[2, n_img:] = False
    return m


@pytest.mark.parametrize("route", ["xla", "k2", "k3"])
def test_attention_heads_last_matches_jax(route, monkeypatch):
    rng = np.random.default_rng(11)
    s, d, n_head = 5 + 40, 128, 2  # Dh=64 as BERT
    q, k, v = (rng.normal(size=(4, s, d)).astype(np.float32) for _ in range(3))
    mask = _mmbt_key_masks(s, rng)
    calls = []
    impl = "xla" if route == "xla" else "pallas_interpret"
    if route == "k3":
        monkeypatch.setattr(JA, "_WHOLE_SEQ_VMEM_CAP", 1)
    spied = {"k2": "_sdpa_pallas_hl", "k3": "attention_flash"}.get(route)
    if spied:
        real = getattr(JA, spied)
        monkeypatch.setattr(JA, spied, lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ref = JA.attention_heads_last(*(jnp.asarray(t) for t in (q, k, v)), jnp.asarray(mask),
                                  n_head=n_head, impl=impl)
    assert len(calls) == (1 if spied else 0)  # the JAX route under test was taken
    out = TA.attention_heads_last(*(torch.from_numpy(t) for t in (q, k, v)),
                                  torch.from_numpy(mask), n_head=n_head)
    assert out.shape == (4, s, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_attention_heads_last_runs_through_the_autograd_function():
    q, k, v = (torch.randn(2, 9, 64, requires_grad=True) for _ in range(3))
    out = TA.attention_heads_last(q, k, v, torch.ones(2, 9, dtype=torch.bool), n_head=2)
    assert type(out.grad_fn).__name__ == "_AttentionBackward"
    with pytest.raises(ValueError, match="divisible"):
        TA.attention_heads_last(q, k, v, n_head=3)


def test_forward_kernel_takes_dh32_and_the_backward_does_not():
    """Dh=32 (the tiny BERT config) had a forward instance only until MMBT
    training came; now both kernels take it, so ``--tiny`` trains on the card,
    and the dropout instances take BERT's head dims. Both kernels also take
    the head dims of FLAVA fusion's other head counts (24 to 768)."""
    every = (24, 32, 48, 64, 96, 128, 192, 256, 384, 768)
    assert TA.KERNEL_HEAD_DIMS == {"attention_fwd_cuda": every,
                                   "attention_bwd_cuda": every,
                                   "attention_fwd_dropout_cuda": (32, 64),
                                   "attention_bwd_dropout_cuda": (32, 64)}


# ---------------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------------


def _close_to_scale(got, ref, rel=1e-5):
    np.testing.assert_allclose(got, ref, atol=rel * float(np.abs(ref).max()), rtol=0)


def test_bottleneck_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    jblock = JR.TVBottleneck(16, stride=2, downsample=True)
    variables = _redraw_batchnorm(jblock.init(jax.random.key(2), jnp.asarray(x)), seed=2)
    ref = jblock.apply(variables, jnp.asarray(x))
    tblock = TR.Bottleneck(32, 16, 2, True).eval()
    tblock.load_state_dict(mmbt_state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        out = tblock(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close_to_scale(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref))


def test_resnet_trunk_matches_jax():
    """Conv 7x7/2 with padding 3, max-pool 3x3/2 with padding 1, the stride-2
    3x3 convs with torch's symmetric padding, at an even input size."""
    x = _inputs(3)[3]
    jtrunk = JR.ResNetTrunkTV(RESNET)
    variables = _redraw_batchnorm(jtrunk.init(jax.random.key(3), jnp.asarray(x), train=False),
                                  seed=3)
    ref = np.asarray(jtrunk.apply(variables, jnp.asarray(x), train=False))
    ttrunk = TR.ResNetTrunk(RESNET).eval()
    ttrunk.load_state_dict(mmbt_state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        out = ttrunk(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert out.shape == (B, 2048, 2, 2)
    _close_to_scale(out.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("n,mode", [(3, "avg"), (4, "avg"), (4, "max")])
def test_image_encoder_matches_jax(n, mode):
    """N=3 pools the 2x2 feature map to a (3, 1) grid (overlapping windows),
    N=4 to (2, 2); the N embeddings come out in the JAX reshape's order."""
    x = _inputs(4)[3]
    jenc = JR.ImageEncoder(n, mode, RESNET)
    variables = _redraw_batchnorm(jenc.init(jax.random.key(4), jnp.asarray(x), train=False),
                                  seed=4)
    ref = np.asarray(jenc.apply(variables, jnp.asarray(x), train=False))
    tenc = TR.ImageEncoder(n, mode, RESNET).eval()
    tenc.load_state_dict(mmbt_state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        out = tenc(torch.from_numpy(x))
    assert out.shape == ref.shape == (B, n, 2048)
    _close_to_scale(out.numpy(), ref)


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------


def test_bert_layer_and_pooler_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 21, 128)).astype(np.float32)
    mask = _mmbt_key_masks(21, rng)[:3]
    jcfg, tcfg = JB.BertConfig(**BERT), TB.BertConfig(**BERT)
    jlayer = JB.BertLayer(jcfg, "xla")
    variables = jlayer.init(jax.random.key(5), jnp.asarray(x), jnp.asarray(mask))
    ref = np.asarray(jlayer.apply(variables, jnp.asarray(x), jnp.asarray(mask)))
    tlayer = TB.BertLayer(tcfg).eval()
    tlayer.load_state_dict(mmbt_state_dict_from_jax(variables), strict=True)
    jpool = JB.BertPooler(jcfg)
    pvars = jpool.init(jax.random.key(6), jnp.asarray(ref))
    tpool = TB.BertPooler(tcfg).eval()
    tpool.load_state_dict(mmbt_state_dict_from_jax(pvars), strict=True)
    with torch.inference_mode():
        out = tlayer(torch.from_numpy(x), torch.from_numpy(mask))
        pooled = tpool(out)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpool.apply(pvars, jnp.asarray(ref))),
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

_ATTN = {"xla": "xla", "k2": "pallas_interpret", "k3": "pallas_interpret"}


def _keep(variant, n, lt):
    helper = JaxEncoder(JB.BertConfig(**BERT), 3)
    return {"full": None, "img_only": helper.img_only_mask(n, lt),
            "txt_only": helper.txt_only_mask(n, lt)}[variant]


def logits_max_err(variant: str, route: str) -> float:
    """Max |port - JAX| over the (B, C) logits for one keep mask and one JAX
    attention route."""
    variables, tmodel = _pair()
    x = _inputs(6)
    keep = _keep(variant, B, L)
    cap = JA._WHOLE_SEQ_VMEM_CAP
    if route == "k3":
        JA._WHOLE_SEQ_VMEM_CAP = 1
    try:
        ref = np.asarray(_jax_mmbt(_ATTN[route]).apply(
            variables, tuple(jnp.asarray(a) for a in x), train=False, seq_keep_mask=keep))
    finally:
        JA._WHOLE_SEQ_VMEM_CAP = cap
    with torch.inference_mode():
        out = tmodel(_torch(x), seq_keep_mask=None if keep is None
                     else torch.from_numpy(np.array(keep)))
    assert out.shape == ref.shape == (B, N_CLASSES)
    return float(np.abs(out.numpy() - ref).max())


@pytest.mark.parametrize("route", list(_ATTN))
@pytest.mark.parametrize("variant", ["full", "img_only", "txt_only"])
def test_mmbt_logits_match_jax(variant, route):
    assert logits_max_err(variant, route) <= 1e-4


def test_mmbt_four_image_embeddings_match_jax():
    variables, tmodel = _pair(4)
    x = _inputs(7)
    ref = np.asarray(_jax_mmbt("xla", 4).apply(variables, tuple(jnp.asarray(a) for a in x),
                                               train=False))
    with torch.inference_mode():
        out = tmodel(_torch(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("variant", ["img_only", "txt_only"])
def test_keep_masks_match_jax(variant):
    _, tmodel = _pair()
    got = getattr(tmodel.enc, f"{variant}_mask")(3, 8)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(_keep(variant, 3, 8)))


def test_state_dict_names_and_layouts():
    """HF BERT and torchvision ResNet names; conv kernels HWIO -> OIHW,
    Linear kernels transposed, BatchNorm statistics carried across."""
    variables, tmodel = _pair()
    sd = tmodel.state_dict()
    enc_p, enc_s = variables["params"]["enc"], variables["batch_stats"]["enc"]
    np.testing.assert_array_equal(
        sd["enc.encoder.layer.1.attention.self.key.weight"].numpy(),
        enc_p["encoder"]["layer_1"]["self"]["key"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["enc.img_encoder.model.layer2.0.conv2.weight"].numpy(),
        enc_p["img_encoder"]["model"]["layer2_0"]["conv2"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["enc.img_encoder.model.layer4.0.downsample.1.running_var"].numpy(),
        enc_s["img_encoder"]["model"]["layer4_0"]["downsample_bn"]["bn"]["var"])
    np.testing.assert_array_equal(sd["enc.txt_embeddings.LayerNorm.weight"].numpy(),
                                  enc_p["txt_embeddings"]["ln_weight"])
    for name in ("enc.encoder.layer.0.attention.output.LayerNorm.bias",
                 "enc.encoder.layer.0.intermediate.dense.weight",
                 "enc.encoder.layer.0.output.dense.weight", "enc.pooler.dense.weight",
                 "enc.img_embeddings.img_embeddings.weight", "clf.weight",
                 "enc.img_encoder.model.bn1.num_batches_tracked"):
        assert name in sd, name


def test_cls_and_sep_ids_must_index_the_word_table():
    with pytest.raises(ValueError, match="word table"):
        MultimodalBertClf(TB.BertConfig(**{**BERT, "vocab_size": 100}), N_CLASSES,
                          resnet_layers=RESNET)


if __name__ == "__main__":
    # the measured maxima of the whole-model comparison, for the records
    for v in ("full", "img_only", "txt_only"):
        for r in _ATTN:
            print(f"MMBT logits, {v} keep mask, JAX route {r}: max |port - JAX| "
                  f"{logits_max_err(v, r):.3g}")
