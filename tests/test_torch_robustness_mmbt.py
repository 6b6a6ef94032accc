"""The port's MMBT robustness sweep (``evals/robustness_mmbt.py``, the
``eval_mmbt_robustness`` CLI) against the JAX package's, on the CPU.

The keep masks are held to the JAX package's bit for bit. The sweep runs a
tiny MMBT whose weights come from the JAX model's init and cross
over through ``mmbt_state_dict_from_jax``; both packages get the same uint8
numpy batches (normalised on the device by each), the JAX side through an
apply built as its ``setup_mmbt``'s, with its XLA attention, as
``tests/test_robustness.py`` runs it, the port with its plain attention (the
CUDA kernels run only on the card).

Tolerance: predictions within 1e-4 x max(1, max|jax|) (fp32 through a ResNet
and a BERT layer, summed in another order); the port's chunkings agree with
each other to the same bound.
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

from multimodal_uncertainty_tpu.evals.robustness_mmbt import (
    build_mmbt_variant_masks as jax_masks,
)
from multimodal_uncertainty_tpu.evals.robustness_mmbt import (
    mmbt_robustness_sweep as jax_sweep,
)
from multimodal_uncertainty_tpu.data.images import FOOD101_MEAN as JAX_MEAN
from multimodal_uncertainty_tpu.data.images import FOOD101_STD as JAX_STD
from multimodal_uncertainty_tpu.data.images import normalize_on_device as jax_normalize
from multimodal_uncertainty_tpu.models import bert as JB
from multimodal_uncertainty_tpu.models.mmbt import MultimodalBertClf as JaxMMBT
from multimodal_uncertainty_tpu_torch import eval_mmbt_robustness as cli
from multimodal_uncertainty_tpu_torch.data.food101 import get_food101
from multimodal_uncertainty_tpu_torch.data.images import write_ppm
from multimodal_uncertainty_tpu_torch.evals import build_mmbt_variant_masks, mmbt_robustness_sweep
from multimodal_uncertainty_tpu_torch.models import bert as TB
from multimodal_uncertainty_tpu_torch.models.jax_import import mmbt_state_dict_from_jax
from multimodal_uncertainty_tpu_torch.models.mmbt import MultimodalBertClf
from multimodal_uncertainty_tpu_torch.training.checkpoint import save_weights
from multimodal_uncertainty_tpu_torch.zoo import setup_mmbt

BERT = dict(vocab_size=120, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.0)
N_CLASSES, RESNET, IMG, N_IMG, REPEATS = 4, (1, 1, 1, 1), 64, 3, 2


@pytest.mark.parametrize("seed,txt_len,num_image_embeds,n_repeats",
                         [(0, 6, 3, 2), (7, 32, 1, 20), (42, 1, 4, 5)])
def test_variant_masks_equal_jax(seed, txt_len, num_image_embeds, n_repeats):
    got, want = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):  # a second batch draws on from the same generator
        a = build_mmbt_variant_masks(got, txt_len, num_image_embeds, n_repeats)
        b = jax_masks(want, txt_len, num_image_embeds, n_repeats)
        assert a.dtype == b.dtype == bool and a.shape == (3 + 2 * n_repeats,
                                                          num_image_embeds + 2 + txt_len)
        np.testing.assert_array_equal(a, b)
    assert a[:, 0].all()  # [CLS] in every variant


def _loader(seed=5):
    """Two batches in the food101 loader's layout: ragged texts, uint8 images
    (one shape, so the JAX sweep compiles once)."""
    rng = np.random.default_rng(seed)
    batches = []
    for b, lt in ((3, 8), (3, 8)):
        lengths = rng.integers(2, lt + 1, size=b)
        lengths[0] = lt
        mask = (np.arange(lt)[None] < lengths[:, None]).astype(np.int64)
        text = rng.integers(104, BERT["vocab_size"], (b, lt)) * mask
        imgs = rng.integers(0, 256, (b, IMG, IMG, 3), dtype=np.uint8)
        batches.append(((text, mask.copy(), mask, imgs), rng.integers(0, N_CLASSES, b)))
    return batches


@functools.lru_cache(maxsize=None)
def _models():
    """The JAX MMBT's apply as its ``setup_mmbt`` builds it (uint8 images
    normalised on the device, the keep mask passed through) with its init,
    and the port's MMBT with the same weights (BatchNorm statistics redrawn,
    so the running statistics are exercised)."""
    jmodel = JaxMMBT(config=JB.BertConfig(**BERT), n_classes=N_CLASSES, num_image_embeds=N_IMG,
                     resnet_layers=RESNET, attn_impl="xla")
    x = tuple(jnp.asarray(a) for a in _loader()[0][0])
    variables = jax.jit(functools.partial(jmodel.init, train=False))(
        {"params": jax.random.key(2)}, x[:3] + (x[3].astype(jnp.float32),))
    rng = np.random.default_rng(3)
    variables = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), dict(variables))
    for leaf in jax.tree_util.tree_leaves(variables["batch_stats"]):
        leaf[...] = rng.uniform(0.5, 1.5, leaf.shape)

    def apply_fn(v, x, *, train, rngs, seq_keep_mask=None):
        txt, mask, segment, img = x
        img = jax_normalize(img, JAX_MEAN, JAX_STD) if img.dtype == jnp.uint8 else img
        return jmodel.apply(v, (txt, mask, segment, img), train=train,
                            seq_keep_mask=seq_keep_mask), {}

    tmodel = MultimodalBertClf(TB.BertConfig(**BERT), N_CLASSES, N_IMG, resnet_layers=RESNET)
    tmodel.load_state_dict(mmbt_state_dict_from_jax(variables), strict=True)
    return apply_fn, variables, tmodel


def test_sweep_equals_jax_sweep(tmp_path):
    apply_fn, variables, tmodel = _models()
    loader = _loader()
    ref, ref_labels = jax_sweep(apply_fn, variables, loader, num_image_embeds=N_IMG,
                                n_repeats=REPEATS, seed=11)
    preds, labels = mmbt_robustness_sweep(tmodel, loader, num_image_embeds=N_IMG,
                                          n_repeats=REPEATS, seed=11, save_path=str(tmp_path),
                                          checkpoint_name="ckpt", phase="dev")
    assert preds.shape == ref.shape == (6, 3 + 2 * REPEATS, N_CLASSES)
    assert preds.dtype == np.float32
    np.testing.assert_array_equal(labels, ref_labels)
    assert np.abs(np.asarray(preds) - ref).max() <= 1e-4 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_array_equal(
        np.load(tmp_path / "robustness_ckpt_predictions_dev.npy"), preds)
    np.testing.assert_array_equal(np.load(tmp_path / "robustness_ckpt_labels_dev.npy"), labels)


def test_chunkings_agree_and_the_image_is_encoded_once_a_batch():
    _, _, tmodel = _models()
    loader = _loader(6)
    calls = []
    hook = tmodel.enc.img_encoder.register_forward_hook(lambda *_: calls.append(1))
    try:
        runs = {chunk: mmbt_robustness_sweep(tmodel, loader, num_image_embeds=N_IMG,
                                             n_repeats=REPEATS, seed=4, variant_chunk=chunk)[0]
                for chunk in (1, 3, 8)}
    finally:
        hook.remove()
    assert len(calls) == 3 * len(loader)  # three sweeps, one ResNet pass a batch each
    scale = max(1.0, float(np.abs(runs[8]).max()))
    for chunk in (1, 3):
        assert np.abs(runs[chunk] - runs[8]).max() <= 1e-4 * scale
    # column 1 / 2 are the encoder's own image-only / text-only forwards
    x = tuple(torch.from_numpy(a) for a in loader[0][0])
    from multimodal_uncertainty_tpu_torch.data.images import FOOD101_MEAN, FOOD101_STD, \
        normalize_on_device
    x = x[:3] + (normalize_on_device(x[3], FOOD101_MEAN, FOOD101_STD),)
    b, lt = x[0].shape
    with torch.no_grad():
        img_only = tmodel(x, seq_keep_mask=tmodel.enc.img_only_mask(b, lt)).numpy()
        txt_only = tmodel(x, seq_keep_mask=tmodel.enc.txt_only_mask(b, lt)).numpy()
    assert np.abs(runs[8][:b, 1] - img_only).max() <= 1e-4 * scale
    assert np.abs(runs[8][:b, 2] - txt_only).max() <= 1e-4 * scale


def _write_tree(root, rng, n=(6, 6, 4), labels=("pho", "ramen", "tacos")):
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
                    rng.choice(words, size=int(rng.integers(2, 40))))}) + "\n")


def test_sweep_cli_on_the_cpu(tmp_path, capsys):
    """``--tiny --device cpu`` on a port checkpoint: both files with their
    shapes, equal to the sweep run in-process; ``val`` is ``dev``."""
    root = str(tmp_path / "food101")
    _write_tree(root, np.random.default_rng(8))
    tiny = dataclasses.replace(TB.BertConfig.base(), hidden_size=64, num_hidden_layers=2,
                               num_attention_heads=2, intermediate_size=128)
    setup = setup_mmbt(n_classes=3, bert_config=tiny, resnet_layers=RESNET, vocab_size=122,
                       seed=9, device="cpu")
    ckpt = str(tmp_path / "run" / "model_best_val.pt")
    os.makedirs(os.path.dirname(ckpt))
    save_weights(setup.model, None, ckpt)
    out = tmp_path / "sweep"
    cli.main(["--save_path", str(out), "--phase", "val", "--batch_size", "4",
              "--checkpoint_path", ckpt, "--n_repeats", "2", "--dataset", "food101",
              "--datapath", root, "--tiny", "--device", "cpu", "--seed", "3"])
    preds = np.load(out / "robustness_model_best_val_predictions_val.npy")
    labels = np.load(out / "robustness_model_best_val_labels_val.npy")
    assert preds.shape == (6, 7, 3) and preds.dtype == np.float32 and labels.shape == (6,)
    assert "Gathered predictions of 6 samples, 7 variants, 3 classes" in capsys.readouterr().out
    _, dev, _, _, _ = get_food101(datapath=root, batch_size=4, n_workers=0)
    want, want_labels = mmbt_robustness_sweep(setup.model, dev, n_repeats=2, seed=3)
    np.testing.assert_array_equal(preds, want)
    np.testing.assert_array_equal(labels, want_labels)


def test_sweep_cli_rejects_a_mesh_before_loading_data(tmp_path, capsys):
    with pytest.raises(SystemExit):
        cli.main(["--save_path", str(tmp_path), "--phase", "dev", "--batch_size", "4",
                  "--checkpoint_path", str(tmp_path / "missing.pt"), "--dataset", "food101",
                  "--datapath", str(tmp_path / "no_such_tree"), "--device", "cpu",
                  "--data_parallel", "2"])
    assert "mesh sweeps (--data_parallel)" in capsys.readouterr().err


def test_sweep_cli_runs_on_the_card_or_raises(tmp_path, monkeypatch):
    """Without ``--device cpu`` the CLI runs on ``cuda``; with no card it
    raises before any data loads (the tree does not exist)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--save_path", str(tmp_path), "--phase", "dev", "--batch_size", "4",
                  "--checkpoint_path", str(tmp_path / "missing.pt"), "--dataset", "food101",
                  "--datapath", str(tmp_path / "no_such_tree")])
