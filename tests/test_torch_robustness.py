"""The port's FLAVA robustness sweep, its artifacts and its tables against the
JAX package's, on the CPU.

The variant masks come from ``np.random.default_rng(seed)`` on both sides, so
the whole (S, V, E, C) prediction array is held to the JAX sweep's: a small
FLAVA fusion model (D=96, 2 layers, 4 heads, so the JAX package routes its
attention to the heads-first kernel K6 in interpret mode), weights carried
across with ``fusion_state_dict_from_jax``, two batches of four rows, S = 32 +
32, ``n_repeats=2`` (V = 7). Tolerance 1e-5: fp32 through 2 layers summed in
another order. The tables are numpy copies and must agree exactly (1e-12).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multimodal_uncertainty_tpu.analysis import robustness_tables as jax_tables
from multimodal_uncertainty_tpu.analysis import utils as jax_utils
from multimodal_uncertainty_tpu.evals import artifacts as jax_artifacts
from multimodal_uncertainty_tpu.evals import robustness_transformer as jax_sweep
from multimodal_uncertainty_tpu.models.fusion import FlavaFusionTransformer as JaxFusion
from multimodal_uncertainty_tpu.ops import attention as JA
from multimodal_uncertainty_tpu_torch import analysis as port_analysis
from multimodal_uncertainty_tpu_torch.analysis import robustness_tables as port_tables
from multimodal_uncertainty_tpu_torch.evals import artifacts as port_artifacts
from multimodal_uncertainty_tpu_torch.evals import robustness_transformer as port_sweep
from multimodal_uncertainty_tpu_torch.models.fusion import FlavaFusionTransformer
from multimodal_uncertainty_tpu_torch.models.jax_import import fusion_state_dict_from_jax

WIDTHS = dict(out_dim=2, num_classes=3, image_hidden_size=16, text_hidden_size=16,
              multimodal_hidden_size=96, multimodal_num_attention_heads=4,
              multimodal_num_hidden_layers=2)


@pytest.mark.parametrize("l_img,l_txt,n_repeats,seed", [(224, 96, 20, 42), (32, 64, 3, 0),
                                                        (5, 300, 4, 7)])
def test_variant_masks_equal_jax(l_img, l_txt, n_repeats, seed):
    ji, jt = jax_sweep.build_variant_masks(np.random.default_rng(seed), l_img, l_txt, n_repeats)
    pi, pt = port_sweep.build_variant_masks(np.random.default_rng(seed), l_img, l_txt, n_repeats)
    assert pi.shape == (3 + 2 * n_repeats, l_img) and pt.shape == (3 + 2 * n_repeats, l_txt)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pt, jt)
    rng_j, rng_p = np.random.default_rng(seed), np.random.default_rng(seed)
    for kind in ("image", "text"):
        for a, b in zip(jax_sweep.input_sampling_masks(rng_j, l_img, l_txt, kind),
                        port_sweep.input_sampling_masks(rng_p, l_img, l_txt, kind)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("axis", [0, 1])
def test_concat_maybe_memmap_writes_the_same_bytes(axis, tmp_path):
    rng = np.random.default_rng(1)
    parts = [rng.normal(size=(3, 4, 2)).astype(np.float32),
             rng.normal(size=(2, 4, 2)).astype(np.float64) if axis == 0
             else rng.normal(size=(3, 5, 2)).astype(np.float64)]
    port = port_artifacts.concat_maybe_memmap(parts, axis=axis, path=str(tmp_path / "p" / "a.npy"))
    jax_ = jax_artifacts.concat_maybe_memmap(parts, axis=axis, path=str(tmp_path / "j" / "a.npy"))
    np.save(tmp_path / "ref.npy", np.concatenate(parts, axis=axis))
    ref = (tmp_path / "ref.npy").read_bytes()
    assert (tmp_path / "p" / "a.npy").read_bytes() == (tmp_path / "j" / "a.npy").read_bytes() == ref
    np.testing.assert_array_equal(np.asarray(port), np.asarray(jax_))
    np.testing.assert_array_equal(port_artifacts.concat_maybe_memmap(parts, axis=axis),
                                  np.concatenate(parts, axis=axis))


def _loader(seed=5):
    """Two batches of four rows: 32 image and 32 text tokens (zero padding
    included, as the packed loader gives them)."""
    rng = np.random.default_rng(seed)
    batches = []
    for i in range(2):
        img = rng.normal(size=(4, 32, 16)).astype(np.float32)
        txt = rng.normal(size=(4, 32, 16)).astype(np.float32)
        img[:, 27:] = 0.0
        txt[:, 10 + 7 * i:] = 0.0
        batches.append(((img, txt), np.arange(4 * i, 4 * i + 4) % 3))
    return batches


def test_sweep_equals_jax_sweep_on_k6(tmp_path, monkeypatch):
    """The whole (S, V, E, C) array and the labels of the port's sweep equal
    the JAX sweep's (its attention on K6 in interpret mode, counted), and the
    two write the same files."""
    calls = []
    real = JA._sdpa_pallas_fwd_impl

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(JA, "_sdpa_pallas_fwd_impl", counting)
    jmodel = JaxFusion(attn_impl="pallas_interpret", **WIDTHS)
    (img, txt), _ = _loader()[0]
    variables = jmodel.init({"params": jax.random.key(11)}, (jnp.asarray(img), jnp.asarray(txt)),
                            train=False)

    def apply_fn(v, x, *, train, rngs, img_mask=None, txt_mask=None):
        return jmodel.apply(v, x, train=train, img_mask=img_mask, txt_mask=txt_mask), {}

    ref, ref_labels = jax_sweep.transformer_robustness_sweep(
        apply_fn, variables, _loader(), n_repeats=2, seed=3, save_path=str(tmp_path / "jax"),
        checkpoint_name="model_best_val", phase="dev")
    assert calls, "the JAX sweep did not reach K6"

    model = FlavaFusionTransformer(**WIDTHS)
    model.load_state_dict(fusion_state_dict_from_jax(variables["params"]), strict=True)
    preds, labels = port_sweep.transformer_robustness_sweep(
        model, _loader(), n_repeats=2, seed=3, save_path=str(tmp_path / "port"),
        checkpoint_name="model_best_val", phase="dev", variant_chunk=3)
    assert preds.shape == (8, 7, 2, 3) and preds.dtype == np.float32
    np.testing.assert_allclose(np.asarray(preds), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(labels, ref_labels)
    for name in ("robustness_model_best_val_predictions_dev.npy",
                 "robustness_model_best_val_labels_dev.npy"):
        got, want = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert not model.training


def test_sweep_batch_chunks_agree_with_one_forward_per_variant():
    """Stacking variants onto the batch axis is exact per row: the chunked
    sweep of one batch equals V separate masked forwards."""
    model = FlavaFusionTransformer(**WIDTHS, generator=torch.Generator().manual_seed(0)).eval()
    (img, txt), _ = _loader()[0]
    im, tm = port_sweep.build_variant_masks(np.random.default_rng(0), 32, 32, 3)
    ti, tt = torch.from_numpy(img), torch.from_numpy(txt)
    with torch.no_grad():
        got = port_sweep.sweep_batch(model, ti, tt, torch.from_numpy(im), torch.from_numpy(tm),
                                     variant_chunk=4)
        for v in range(im.shape[0]):
            want = model((ti, tt), img_mask=torch.from_numpy(im[v]).expand(4, -1).contiguous(),
                         txt_mask=torch.from_numpy(tm[v]).expand(4, -1).contiguous())
            torch.testing.assert_close(got[:, v], want, atol=1e-5, rtol=0)
    assert got.shape == (4, 9, 2, 3)


def _sweep_arrays(seed, s=40, r=3, e=2, c=2):
    rng = np.random.default_rng(seed)
    preds = rng.normal(size=(s, 3 + 2 * r, e, c)).astype(np.float32)
    labels = rng.integers(0, c, size=s)
    labels[:2] = (0, 1)
    return preds, labels


def _assert_frames_equal(a: pd.DataFrame, b: pd.DataFrame):
    assert list(a.columns) == list(b.columns) and len(a) == len(b)
    for col in a.columns:
        if a[col].dtype.kind in "fi":
            np.testing.assert_allclose(a[col].to_numpy(float), b[col].to_numpy(float),
                                       atol=1e-12, rtol=0, err_msg=col)
        else:
            assert list(a[col]) == list(b[col]), col


def test_robustness_tables_equal_jax():
    preds, labels = _sweep_arrays(8, c=3)
    for mmbt in (False, True):
        arr = preds[:, :, 0] if mmbt else preds
        _assert_frames_equal(port_tables.acc_table(arr, labels, mmbt=mmbt, n_repeats=3),
                             jax_tables.acc_table(arr, labels, mmbt=mmbt, n_repeats=3))
        for a, b in zip(port_tables.process_predictions_food101(arr, labels, mmbt, 3),
                        jax_tables.process_predictions_food101(arr, labels, mmbt, 3)):
            np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)
    _assert_frames_equal(port_tables.ece_table(preds, labels, n_repeats=3),
                         jax_tables.ece_table(preds, labels, n_repeats=3))

    preds, labels = _sweep_arrays(9)
    port_out = port_tables.process_predictions_hatefulmeme(preds, labels, n_repeats=3)
    jax_out = jax_tables.process_predictions_hatefulmeme(preds, labels, n_repeats=3)
    for a, b in zip(port_out, jax_out):
        np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)
    _assert_frames_equal(port_tables.auc_table(*port_out), jax_tables.auc_table(*jax_out))
    assert port_analysis.get_correlation(*port_out) == jax_utils.get_correlation(*jax_out)


@pytest.mark.parametrize("dataset", ["hateful-meme-dataset", "food101"])
def test_epoch_wise_analysis_and_ensemble_equal_jax(dataset, tmp_path):
    exp_dir = tmp_path / dataset / "exp"
    exp_dir.mkdir(parents=True)
    for epoch in (1, 2, 4):  # epoch 3 is missing: both skip it
        preds, labels = _sweep_arrays(20 + epoch, r=20)
        np.save(exp_dir / f"robustness_model_epoch_{epoch}_predictions_dev.npy", preds)
        np.save(exp_dir / f"robustness_model_epoch_{epoch}_labels_dev.npy", labels)
    got = port_tables.epoch_wise_analysis("dev", "exp", [1, 2, 3, 4], dataset,
                                          results_dir=str(tmp_path))
    want = jax_tables.epoch_wise_analysis("dev", "exp", [1, 2, 3, 4], dataset,
                                          results_dir=str(tmp_path))
    _assert_frames_equal(got[0], want[0])
    _assert_frames_equal(got[1].reset_index(), want[1].reset_index())
    if dataset == "hateful-meme-dataset":
        assert (port_tables.ensemble_overtime([1, 2, 4], "dev", "exp", dataset, str(tmp_path))
                == jax_tables.ensemble_overtime([1, 2, 4], "dev", "exp", dataset, str(tmp_path)))


def _write_shards(root, n_classes, seed=2):
    """Tiny packed shards (768-wide rows, the widths the CLI's model takes)
    for train / dev / test, and a food101 train.jsonl naming the classes."""
    rng = np.random.default_rng(seed)
    shard_dir = os.path.join(root, "flava_packed")
    os.makedirs(shard_dir)
    with open(os.path.join(root, "train.jsonl"), "w") as f:
        for c in range(n_classes):
            f.write(json.dumps({"label": f"class_{c}"}) + "\n")
    for phase, n in (("train", 4), ("dev", 6), ("test", 4)):
        img_len, txt_len = rng.integers(3, 9, size=n), rng.integers(2, 7, size=n)
        np.save(os.path.join(shard_dir, f"{phase}_img.npy"),
                rng.normal(size=(int(img_len.sum()), 768)).astype(np.float32))
        np.save(os.path.join(shard_dir, f"{phase}_txt.npy"),
                rng.normal(size=(int(txt_len.sum()), 768)).astype(np.float32))
        np.save(os.path.join(shard_dir, f"{phase}_img_offsets.npy"), np.cumsum([0, *img_len]))
        np.save(os.path.join(shard_dir, f"{phase}_txt_offsets.npy"), np.cumsum([0, *txt_len]))
        np.save(os.path.join(shard_dir, f"{phase}_labels.npy"), rng.integers(0, n_classes, n))


@pytest.mark.parametrize("dataset,phase,n_classes", [("food101", "val", 5),
                                                     ("hateful-meme-dataset", "test", 2)])
def test_sweep_cli_on_the_cpu(dataset, phase, n_classes, tmp_path, monkeypatch, capsys):
    """``python -m multimodal_uncertainty_tpu_torch.eval_transformer_robustness
    --device cpu`` over tiny shards: the two files under the checkpoint's
    name, the root CLI's two summary lines, and the same array as the
    in-process sweep of the checkpoint's model. ``val`` reads the dev split;
    the reference's vestigial flags are taken and ignored."""
    from multimodal_uncertainty_tpu_torch import eval_transformer_robustness as cli
    from multimodal_uncertainty_tpu_torch.data.flava_encoded import PackedFlavaDataset
    from multimodal_uncertainty_tpu_torch.training.checkpoint import save_weights
    from multimodal_uncertainty_tpu_torch.zoo import setup_flava

    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    _write_shards(str(tmp_path / "data" / dataset), n_classes)
    model = setup_flava(model_type="MIMO-shuffle-instance", n_classes=n_classes,
                        multimodal_num_hidden_layers=1, seed=9, device="cpu").model
    ckpt = tmp_path / "run" / "model_epoch_3.pt"
    ckpt.parent.mkdir()
    save_weights(model, None, str(ckpt))
    out = tmp_path / "out"
    preds, labels = cli.main([
        "--save_path", str(out), "--phase", phase, "--batch_size", "4",
        "--checkpoint_path", str(ckpt), "--model_type", "MIMO-shuffle-instance",
        "--multimodal_num_hidden_layers", "1", "--n_repeats", "2", "--seed", "4",
        "--dataset", dataset, "--device", "cpu", "--use_gpu", "--verbose"])
    n = len(PackedFlavaDataset(str(tmp_path / "data" / dataset / "flava_packed"),
                               "dev" if phase == "val" else phase))
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2:] == [f"Gathered predictions of {n} samples, 7 variants, 2 heads, "
                          f"{n_classes} classes", f"Gathered labels of {n} samples"]
    saved = np.load(out / f"robustness_model_epoch_3_predictions_{phase}.npy")
    assert saved.shape == (n, 7, 2, n_classes) and saved.dtype == np.float32
    assert np.isfinite(saved).all()
    np.testing.assert_array_equal(np.load(out / f"robustness_model_epoch_3_labels_{phase}.npy"),
                                  labels)

    from multimodal_uncertainty_tpu_torch.data.flava_encoded import get_dataset_flava

    class _Args:
        batch_size, seed, sample_size, n_workers = 4, 4, None, 0

    splits = dict(zip(("train", "dev", "test"),
                      get_dataset_flava(_Args, str(tmp_path / "data" / dataset))))
    again, _ = port_sweep.transformer_robustness_sweep(
        model, splits["dev" if phase == "val" else phase], n_repeats=2, seed=4)
    np.testing.assert_allclose(saved, again, atol=1e-6, rtol=0)


def test_sweep_cli_rejects_a_mesh(tmp_path, capsys):
    from multimodal_uncertainty_tpu_torch import eval_transformer_robustness as cli

    with pytest.raises(SystemExit):
        cli.main(["--save_path", str(tmp_path), "--phase", "dev", "--batch_size", "4",
                  "--checkpoint_path", "x.pt", "--data_parallel", "2", "--device", "cpu"])
    assert "--data_parallel" in capsys.readouterr().err
