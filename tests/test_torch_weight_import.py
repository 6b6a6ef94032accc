"""The port's pretrained-weight import (``models/torch_import.py``) against
the JAX package's ``import_mmbt_pretrained`` / ``import_vilt_pretrained``, on
the CPU.

State dicts are synthesised from a numpy seed with the published names and
shapes, as the JAX package's converter tests do (no weight file is fetched):
BERT in HF ``BertModel`` names and in the legacy ``pytorch_pretrained_bert``
ones (``bert.`` prefix, ``gamma`` / ``beta``, its pre-training heads),
torchvision's ResNet with ``fc.*`` and ``num_batches_tracked``, and HF ViLT
from the key list of the JAX package's ``convert_vilt`` (a classification
dict, an MLM one and a bare ``ViltModel`` one; building a tiny HF model
would need ``transformers``, whose import alone takes about 15 s on the CPU). The
weights the import does not touch come from the JAX model's init through
``models/jax_import.py``.

Tolerances: logits within 1e-4 x max(1, max|jax|) (fp32 through a ResNet
and 2 BERT or ViLT layers, summed in another order); every imported tensor
bit-equal to its source.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.models import bert as JB
from multimodal_uncertainty_tpu.models import torch_import as JI
from multimodal_uncertainty_tpu.models.mmbt import MultimodalBertClf as JaxMMBT
from multimodal_uncertainty_tpu.models.vilt import ViltConfig as JaxViltConfig
from multimodal_uncertainty_tpu.models.vilt import ViltForImagesAndTextClassification as JaxVilt
from multimodal_uncertainty_tpu_torch import train as port_train
from multimodal_uncertainty_tpu_torch.data.images import write_ppm
from multimodal_uncertainty_tpu_torch.models import bert as TB
from multimodal_uncertainty_tpu_torch.models import torch_import as TI
from multimodal_uncertainty_tpu_torch.models.jax_import import (
    mmbt_state_dict_from_jax,
    vilt_state_dict_from_jax,
)
from multimodal_uncertainty_tpu_torch.models.mmbt import MultimodalBertClf
from multimodal_uncertainty_tpu_torch.models.vilt import ViltConfig, ViltForImagesAndTextClassification
from multimodal_uncertainty_tpu_torch.training.checkpoint import load_weights
from multimodal_uncertainty_tpu_torch.zoo import setup_mmbt, setup_vilt

BERT = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=128, max_position_embeddings=64, hidden_dropout_prob=0.0)
N_CLASSES, RESNET, IMG, B, L = 5, (1, 1, 1, 1), 64, 3, 12
VILT = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=128, num_labels=N_CLASSES, image_size=64)


def _t(rng, *shape, std=0.05, mean=0.0):
    return torch.from_numpy((mean + std * rng.normal(size=shape)).astype(np.float32))


def bert_sd(rng, c=BERT, legacy=False):
    """A BERT ``BertModel`` state dict; ``legacy``: ``pytorch_pretrained_bert``
    names with ``BertForPreTraining``'s heads."""
    d, i = c["hidden_size"], c["intermediate_size"]
    sd = {"embeddings.word_embeddings.weight": _t(rng, c["vocab_size"], d),
          "embeddings.position_embeddings.weight": _t(rng, c["max_position_embeddings"], d),
          "embeddings.token_type_embeddings.weight": _t(rng, 2, d),
          "embeddings.position_ids": torch.arange(c["max_position_embeddings"])[None]}
    ln = ["embeddings.LayerNorm"]
    for n in range(c["num_hidden_layers"]):
        p = f"encoder.layer.{n}."
        for name, (o, k) in {"attention.self.query": (d, d), "attention.self.key": (d, d),
                             "attention.self.value": (d, d), "attention.output.dense": (d, d),
                             "intermediate.dense": (i, d), "output.dense": (d, i)}.items():
            sd[p + name + ".weight"], sd[p + name + ".bias"] = _t(rng, o, k), _t(rng, o)
        ln += [p + "attention.output.LayerNorm", p + "output.LayerNorm"]
    sd["pooler.dense.weight"], sd["pooler.dense.bias"] = _t(rng, d, d), _t(rng, d)
    for name in ln:
        sd[name + ".weight"], sd[name + ".bias"] = _t(rng, d, std=0.1, mean=1.0), _t(rng, d)
    if not legacy:
        return sd
    out = {"cls.predictions.bias": _t(rng, c["vocab_size"]),
           "cls.seq_relationship.weight": _t(rng, 2, d)}
    for k, v in sd.items():
        k = k.replace("LayerNorm.weight", "LayerNorm.gamma").replace("LayerNorm.bias",
                                                                     "LayerNorm.beta")
        out["bert." + k] = v
    return out


def resnet_sd(rng, layers=RESNET):
    """A torchvision ResNet state dict (with its ``fc`` head)."""
    sd = {}

    def conv(name, cout, cin, k):
        sd[name + ".weight"] = _t(rng, cout, cin, k, k, std=float(np.sqrt(2.0 / (cout * k * k))))

    def bn(name, c):
        sd[name + ".weight"] = _t(rng, c, std=0.1, mean=1.0)
        sd[name + ".bias"] = _t(rng, c)
        sd[name + ".running_mean"] = _t(rng, c, std=0.1)
        sd[name + ".running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
        sd[name + ".num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    inplanes = 64
    for s, blocks in enumerate(layers):
        planes = (64, 128, 256, 512)[s]
        for j in range(blocks):
            t = f"layer{s + 1}.{j}"
            for n, (co, ci, k) in enumerate(((planes, inplanes, 1), (planes, planes, 3),
                                             (planes * 4, planes, 1)), start=1):
                conv(f"{t}.conv{n}", co, ci, k)
                bn(f"{t}.bn{n}", co)
            if j == 0:
                conv(f"{t}.downsample.0", planes * 4, inplanes, 1)
                bn(f"{t}.downsample.1", planes * 4)
            inplanes = planes * 4
    sd["fc.weight"], sd["fc.bias"] = _t(rng, 1000, 2048), _t(rng, 1000)
    return sd


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _mmbt_inputs(seed):
    rng = np.random.default_rng(seed)
    mask = (np.arange(L)[None] < np.array([[L], [5], [8]])).astype(np.int32)
    txt = (rng.integers(0, BERT["vocab_size"], (B, L)) * mask).astype(np.int32)
    return txt, mask, mask.copy(), rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_mmbt():
    """The JAX MMBT's jitted apply and its init, as numpy trees."""
    jmodel = JaxMMBT(config=JB.BertConfig(**BERT), n_classes=N_CLASSES, resnet_layers=RESNET,
                     dropout=0.0, attn_impl="xla")
    variables = jax.jit(functools.partial(jmodel.init, train=False))(
        {"params": jax.random.key(3)}, tuple(jnp.asarray(a) for a in _mmbt_inputs(0)))
    return (jax.jit(functools.partial(jmodel.apply, train=False)),
            jax.tree_util.tree_map(lambda a: np.array(a, np.float32), dict(variables)))


def _mmbt_pair():
    """The JAX MMBT's apply and init, and the port's MMBT holding the same weights."""
    apply, variables = _jax_mmbt()
    tmodel = MultimodalBertClf(TB.BertConfig(**BERT), N_CLASSES, resnet_layers=RESNET).eval()
    tmodel.load_state_dict(mmbt_state_dict_from_jax(variables), strict=True)
    return apply, variables, tmodel


@pytest.mark.parametrize("legacy", [False, True], ids=["hf", "legacy"])
def test_mmbt_import_matches_jax_and_copies_bit_exact(legacy):
    rng = np.random.default_rng(11)
    bsd, rsd = bert_sd(rng, legacy=legacy), resnet_sd(rng)
    apply, variables, tmodel = _mmbt_pair()
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    params = dict(tmodel.named_parameters())
    mapped = TI.import_mmbt_pretrained(tmodel, bsd, rsd)
    assert all(p is params[n] for n, p in tmodel.named_parameters())  # copied in place
    own = tmodel.state_dict()
    for k, t in mapped.items():
        assert torch.equal(own[k], t), k
    assert len(mapped) == sum(not k.endswith(("position_ids", "num_batches_tracked"))
                              and not k.startswith(("fc.", "cls.", "bert.cls.")) for k in
                              list(bsd) + list(rsd))
    for k in ("clf.weight", "enc.img_embeddings.img_embeddings.weight"):  # no source: untouched
        assert torch.equal(own[k], before[k])
    assert int(own["enc.img_encoder.model.bn1.num_batches_tracked"]) == 0  # dropped, as JAX

    jvars = JI.import_mmbt_pretrained(variables, _numpy(bsd), _numpy(rsd), num_layers=2,
                                      resnet_layers=RESNET)
    x = _mmbt_inputs(1)
    ref = np.asarray(apply(jvars, tuple(jnp.asarray(a) for a in x)))
    with torch.inference_mode():
        out = tmodel(tuple(torch.from_numpy(a).long() if a.dtype != np.float32
                           else torch.from_numpy(a) for a in x)).numpy()
    assert np.abs(out - ref).max() <= 1e-4 * max(1.0, float(np.abs(ref).max()))
    # and the port's MMBT state equals JAX's merged tree, converted
    want = mmbt_state_dict_from_jax(jvars)
    for k in mapped:
        assert torch.equal(own[k], want[k]), k


def test_mmbt_import_names_what_is_wrong():
    rng = np.random.default_rng(12)
    tmodel = MultimodalBertClf(TB.BertConfig(**BERT), N_CLASSES, resnet_layers=RESNET)
    narrow = bert_sd(rng, dict(BERT, hidden_size=32, intermediate_size=64))
    with pytest.raises(ValueError, match=r"enc\.txt_embeddings\.word_embeddings\.weight"):
        TI.import_mmbt_pretrained(tmodel, bert_sd=narrow)
    unknown = dict(bert_sd(rng), **{"encoder.extra.weight": torch.zeros(3)})
    with pytest.raises(KeyError, match="encoder.extra.weight"):
        TI.import_mmbt_pretrained(tmodel, bert_sd=unknown)
    with pytest.raises(KeyError, match=r"layer5\.0\.conv1\.weight"):
        TI.import_mmbt_pretrained(tmodel, resnet_sd=dict(resnet_sd(rng),
                                                         **{"layer5.0.conv1.weight": 0 * torch.ones(1)}))
    missing = bert_sd(rng)
    del missing["encoder.layer.1.output.dense.bias"]
    with pytest.raises(KeyError, match=r"enc\.encoder\.layer\.1\.output\.dense\.bias"):
        TI.import_mmbt_pretrained(tmodel, bert_sd=missing)


def test_setup_mmbt_optimizer_steps_the_imported_parameters():
    rng = np.random.default_rng(13)
    bsd, rsd = bert_sd(rng), resnet_sd(rng)
    setup = setup_mmbt(n_classes=N_CLASSES, bert_config=TB.BertConfig(**BERT),
                       resnet_layers=RESNET, gradient_accumulation_steps=1,
                       pretrained_bert_sd=bsd, pretrained_resnet_sd=rsd, device="cpu")
    model, opt = setup.model, setup.optimizer
    assert {n: id(p) for n, p in opt.params.items()} == {
        n: id(p) for n, p in model.named_parameters()}
    pooler = model.enc.pooler.dense.weight
    assert torch.equal(pooler, bsd["pooler.dense.weight"])
    assert torch.equal(model.enc.img_encoder.model.layer4[0].bn3.running_var,
                       rsd["layer4.0.bn3.running_var"])
    for _ in range(2):  # the warmup schedule's rate is 0 at step 0
        opt.update({n: torch.ones_like(p) for n, p in model.named_parameters()})
    assert not torch.equal(pooler, bsd["pooler.dense.weight"])  # the optimizer moved it
    assert pooler is model.enc.pooler.dense.weight


# ---------------------------------------------------------------- ViLT


def vilt_sd(rng, c=VILT, layout="classification"):
    """An HF ViLT state dict: ``classification`` (ViltForImagesAndText-
    Classification), ``mlm`` (ViltForMaskedLM: the MLM / ITM heads, no
    classifier) or ``bare`` (ViltModel: no ``vilt.`` prefix, no head)."""
    d, i = c["hidden_size"], c["intermediate_size"]
    g = c["image_size"] // 32
    e = "vilt.embeddings."
    sd = {e + "text_embeddings.word_embeddings.weight": _t(rng, c["vocab_size"], d),
          e + "text_embeddings.position_embeddings.weight": _t(rng, 40, d),
          e + "text_embeddings.token_type_embeddings.weight": _t(rng, 2, d),
          e + "text_embeddings.LayerNorm.weight": _t(rng, d, std=0.1, mean=1.0),
          e + "text_embeddings.LayerNorm.bias": _t(rng, d),
          e + "text_embeddings.position_ids": torch.arange(40)[None],
          e + "token_type_embeddings.weight": _t(rng, 2, d),
          e + "cls_token": _t(rng, 1, 1, d),
          e + "position_embeddings": _t(rng, 1, g * g + 1, d),
          e + "patch_embeddings.projection.weight": _t(rng, d, 3, 32, 32, std=0.01),
          e + "patch_embeddings.projection.bias": _t(rng, d),
          "vilt.layernorm.weight": _t(rng, d, std=0.1, mean=1.0), "vilt.layernorm.bias": _t(rng, d),
          "vilt.pooler.dense.weight": _t(rng, d, d), "vilt.pooler.dense.bias": _t(rng, d)}
    for n in range(c["num_hidden_layers"]):
        p = f"vilt.encoder.layer.{n}."
        for name, (o, k) in {"attention.attention.query": (d, d), "attention.attention.key": (d, d),
                             "attention.attention.value": (d, d), "attention.output.dense": (d, d),
                             "intermediate.dense": (i, d), "output.dense": (d, i)}.items():
            sd[p + name + ".weight"], sd[p + name + ".bias"] = _t(rng, o, k), _t(rng, o)
        for name in ("layernorm_before", "layernorm_after"):
            sd[p + name + ".weight"] = _t(rng, d, std=0.1, mean=1.0)
            sd[p + name + ".bias"] = _t(rng, d)
    if layout == "classification":
        sd.update({"classifier.0.weight": _t(rng, d, d), "classifier.0.bias": _t(rng, d),
                   "classifier.1.weight": _t(rng, d, std=0.1, mean=1.0),
                   "classifier.1.bias": _t(rng, d),
                   "classifier.3.weight": _t(rng, c["num_labels"], d),
                   "classifier.3.bias": _t(rng, c["num_labels"])})
    elif layout == "mlm":
        sd.update({"mlm_score.decoder.weight": _t(rng, c["vocab_size"], d),
                   "mlm_score.bias": _t(rng, c["vocab_size"]),
                   "itm_score.fc.weight": _t(rng, 2, d)})
    else:
        sd = {k[len("vilt."):]: v for k, v in sd.items()}
    return sd


def _vilt_batch(seed):
    rng = np.random.default_rng(seed)
    mask = (np.arange(10)[None] < np.array([[10], [4], [7]])).astype(np.int64)
    return {"input_ids": rng.integers(0, VILT["vocab_size"], (B, 10)) * mask,
            "attention_mask": mask, "token_type_ids": np.zeros((B, 10), np.int64),
            "pixel_values": rng.normal(size=(B, 64, 64, 3)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _jax_vilt():
    """The JAX ViLT's jitted apply (to the logits) and its init params."""
    jmodel = JaxVilt(config=dataclasses.replace(JaxViltConfig.b32(), **VILT), attn_impl="xla")
    variables = jax.jit(functools.partial(jmodel.init, train=False))(
        {"params": jax.random.key(4)}, {k: jnp.asarray(v) for k, v in _vilt_batch(0).items()})
    return (jax.jit(lambda v, b: jmodel.apply(v, b, train=False).logits),
            {"params": jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                              variables["params"])})


@pytest.mark.parametrize("layout", ["classification", "mlm", "bare"])
def test_vilt_import_matches_jax_and_packs_qkv(layout):
    rng = np.random.default_rng(21)
    sd = vilt_sd(rng, layout=layout)
    apply, variables = _jax_vilt()
    tmodel = ViltForImagesAndTextClassification(
        dataclasses.replace(ViltConfig.b32(), **VILT)).eval()
    tmodel.load_state_dict(vilt_state_dict_from_jax(variables), strict=True)
    head = tmodel.cls_out.weight.clone()
    mapped = TI.import_vilt_pretrained(tmodel, sd)
    own = tmodel.state_dict()
    for k, t in mapped.items():
        assert torch.equal(own[k], t), k
    pre = "" if layout == "bare" else "vilt."
    for n in range(2):
        p = f"{pre}encoder.layer.{n}.attention.attention."
        for leaf in ("weight", "bias"):
            assert torch.equal(own[f"vilt.block.{n}.qkv.{leaf}"], torch.cat(
                [sd[p + f"{w}.{leaf}"] for w in ("query", "key", "value")]))
    assert torch.equal(own["vilt.image_position_embeddings"], sd[f"{pre}embeddings.position_embeddings"][0])
    assert torch.equal(own["cls_out.weight"], sd["classifier.3.weight"] if layout == "classification"
                       else head)  # a dict without a head leaves it random

    jsd = {k: v.numpy() for k, v in sd.items()}
    jvars = JI.import_vilt_pretrained(variables, jsd, num_layers=2)
    batch = _vilt_batch(1)
    ref = np.asarray(apply(jvars, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.inference_mode():
        out = tmodel({k: torch.from_numpy(v) for k, v in batch.items()}).logits.numpy()
    assert np.abs(out - ref).max() <= 1e-4 * max(1.0, float(np.abs(ref).max()))


def test_vilt_import_names_what_is_wrong():
    rng = np.random.default_rng(22)
    tmodel = ViltForImagesAndTextClassification(dataclasses.replace(ViltConfig.b32(), **VILT))
    sd = vilt_sd(rng)
    del sd["vilt.encoder.layer.1.attention.attention.key.weight"]
    with pytest.raises(KeyError, match=r"layer\.1\.attention\.attention\.key\.weight"):
        TI.import_vilt_pretrained(tmodel, sd)
    with pytest.raises(KeyError, match="vilt.encoder.layer.0.crossattention.weight"):
        TI.import_vilt_pretrained(tmodel, dict(vilt_sd(rng), **{
            "vilt.encoder.layer.0.crossattention.weight": torch.zeros(2)}))
    wide = vilt_sd(rng, dict(VILT, hidden_size=128, intermediate_size=256))
    with pytest.raises(ValueError, match="vilt.word_embeddings"):
        TI.import_vilt_pretrained(tmodel, wide)
    setup = setup_vilt(n_classes=N_CLASSES, vilt_config=dataclasses.replace(ViltConfig.b32(),
                                                                            **VILT),
                       pretrained_vilt_sd=vilt_sd(rng, layout="bare"), device="cpu")
    assert {n: id(p) for n, p in setup.optimizer.params.items()} == {
        n: id(p) for n, p in setup.model.named_parameters()}


# ---------------------------------------------------------------- the train CLI


def _write_tree(root, rng, n=(8, 4, 4), labels=("pho", "ramen", "tacos")):
    """A Food-101 tree of 256x256 P6 images and a vocabulary with BERT's ids."""
    os.makedirs(os.path.join(root, "images"))
    words = [f"w{i}" for i in range(18)]
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(["[PAD]"] + [f"[unused{i}]" for i in range(99)]
                          + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words) + "\n")
    for split, count in zip(("train", "dev", "test"), n):
        with open(os.path.join(root, f"{split}.jsonl"), "w") as f:
            for i in range(count):
                name = f"images/{split}_{i}.ppm"
                write_ppm(os.path.join(root, name), rng.integers(0, 256, (256, 256, 3), np.uint8))
                f.write(json.dumps({"label": labels[i % len(labels)], "img": name, "text": " ".join(
                    rng.choice(words, size=int(rng.integers(2, 20))))}) + "\n")


def test_mmbt_train_cli_loads_the_weight_files(tmp_path, monkeypatch):
    """``--tiny --bert_weights --resnet_weights --device cpu``, 1 epoch with
    both encoders frozen: the checkpoint's BERT encoder and ResNet equal the
    files' tensors; ``--vilt_weights`` is refused for MMBT."""
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    _write_tree(str(tmp_path / "data" / "food101"), np.random.default_rng(5))
    rng = np.random.default_rng(14)
    cfg = dict(BERT, vocab_size=122, max_position_embeddings=512)
    bsd, rsd = bert_sd(rng, cfg, legacy=True), resnet_sd(rng)
    torch.save(bsd, tmp_path / "bert.bin")
    torch.save(rsd, tmp_path / "resnet152.pth")
    argv = ["--framework", "mmbt", "--dataset", "food101", "--tiny", "--device", "cpu",
            "--save_path", str(tmp_path / "run"), "--batch_size", "4",
            "--gradient_accumulation_steps", "2", "--n_epochs", "1", "--lr", "1e-4",
            "--bert_weights", str(tmp_path / "bert.bin"),
            "--resnet_weights", str(tmp_path / "resnet152.pth")]
    port_train.main(argv)
    sd, _ = load_weights(str(tmp_path / "run" / "model_epoch_1.pt"))
    assert torch.equal(sd["enc.encoder.layer.1.attention.self.key.weight"],
                       bsd["bert.encoder.layer.1.attention.self.key.weight"])
    assert torch.equal(sd["enc.encoder.layer.0.output.LayerNorm.weight"],
                       bsd["bert.encoder.layer.0.output.LayerNorm.gamma"])
    assert torch.equal(sd["enc.img_encoder.model.layer3.0.conv2.weight"],
                       rsd["layer3.0.conv2.weight"])
    with pytest.raises(SystemExit):
        port_train.main(argv + ["--vilt_weights", str(tmp_path / "bert.bin")])
