"""The FashionMNIST round's data path in the port against the JAX package's,
on the CPU: ``ArrayLoader``, ``data/fmnist.py`` (idx files, gzipped ones and
the synthetic stand-in), ``data_forming_func`` for the six model types with
the permutations JAX drew injected, and ``model_configure``.

Tolerance: none. Every array here must be equal bit for bit (the same
numpy operations on both sides; the batch forming is indexing only).
"""
import gzip
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu import models as jax_models
from multimodal_uncertainty_tpu.data import fmnist as jax_fmnist
from multimodal_uncertainty_tpu.data import loaders as jax_loaders
from multimodal_uncertainty_tpu.ops import data_forming as jax_forming
from multimodal_uncertainty_tpu_torch import models as port_models
from multimodal_uncertainty_tpu_torch.data import fmnist, loaders
from multimodal_uncertainty_tpu_torch.ops import data_forming


MODEL_TYPES = data_forming.MULTIVIEW_MODEL_TYPES


def _batches(loader, epoch):
    return [tuple(np.asarray(a) for a in batch) for batch in loader.iter_epoch(epoch)]


@pytest.mark.parametrize("n,batch,shuffle,sample_size,arrays", [
    (103, 16, True, None, 2), (103, 16, False, None, 2), (64, 32, True, 40, 3),
    (5, 8, True, None, 2),
])
def test_array_loader_gives_jax_batches_in_jax_order(n, batch, shuffle, sample_size, arrays):
    rng = np.random.default_rng(n)
    data = [rng.normal(size=(n, 4, 1, 3, 3)).astype(np.float32), rng.integers(0, 10, n),
            rng.normal(size=(n, 2))][:arrays]
    port = loaders.ArrayLoader(data, batch, shuffle=shuffle, seed=7, sample_size=sample_size)
    ref = jax_loaders.ArrayLoader(data, batch, shuffle=shuffle, seed=7, sample_size=sample_size)
    assert len(port) == len(ref) and port.n == ref.n
    for epoch in (0, 1, 5):
        got, want = _batches(port, epoch), _batches(ref, epoch)
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            assert len(g) == len(w) == max(2, arrays)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    assert len(_batches(port, 0)[-1][0]) == (port.n - 1) % batch + 1  # the last batch short
    # iter() walks epochs 0, 1, ... as the JAX loader does; iter_epoch skips batches
    for g, w in zip(list(port) + list(port), list(ref) + list(ref)):
        np.testing.assert_array_equal(g[0], w[0])
    for g, w in zip(list(port.iter_epoch(2, 1)), list(ref.iter_epoch(2, 1))):
        np.testing.assert_array_equal(g[-1], w[-1])


def test_array_loader_rejects_arrays_of_other_lengths():
    with pytest.raises(ValueError, match="differ in length"):
        loaders.ArrayLoader([np.zeros(3), np.zeros(4)], 2)


def _write_raw(root, n_train, n_test, rng, gz=False):
    raw = root / "FashionMNIST" / "raw"
    raw.mkdir(parents=True)
    arrays = {}
    for prefix, n in (("train", n_train), ("t10k", n_test)):
        imgs = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
        lbls = rng.integers(0, 10, n).astype(np.uint8)
        for kind, a in (("images-idx3", imgs), ("labels-idx1", lbls)):
            path = raw / f"{prefix}-{kind}-ubyte"
            fmnist.write_idx(str(path), a)
            if gz:
                with open(path, "rb") as src, gzip.open(str(path) + ".gz", "wb") as dst:
                    shutil.copyfileobj(src, dst)
                path.unlink()
        arrays[prefix] = (imgs, lbls)
    return arrays


@pytest.mark.parametrize("gz", [False, True])
def test_get_fmnist_reads_idx_files_as_jax_does(tmp_path, gz):
    arrays = _write_raw(tmp_path, 70, 30, np.random.default_rng(3), gz=gz)
    for train, prefix in ((True, "train"), (False, "t10k")):
        imgs, lbls = fmnist.load_fmnist_arrays(str(tmp_path), train)
        j_imgs, j_lbls = jax_fmnist.load_fmnist_arrays(str(tmp_path), train)
        np.testing.assert_array_equal(imgs, arrays[prefix][0])
        np.testing.assert_array_equal(imgs, j_imgs)
        assert lbls.dtype == j_lbls.dtype == np.int64
        np.testing.assert_array_equal(lbls, j_lbls)
    kw = dict(datapath=str(tmp_path), batch_size=16, seed=11, sample_size=50)
    port, jax_ = fmnist.get_fmnist(**kw), jax_fmnist.get_fmnist(**kw)
    assert port[2] is None and jax_[2] is None
    for p, j in zip(port[:2], jax_[:2]):
        for epoch in (0, 3):
            for (px, py), (jx, jy) in zip(p.iter_epoch(epoch), j.iter_epoch(epoch)):
                assert px.shape[1:] == (4, 1, 14, 14) and px.dtype == np.float32
                np.testing.assert_array_equal(px, jx)
                np.testing.assert_array_equal(py, jy)
    assert port[0].n == 50 and port[1].n == 30


def test_write_idx_is_read_back_by_the_jax_reader(tmp_path):
    a = np.random.default_rng(0).integers(0, 256, (3, 28, 28), dtype=np.uint8)
    fmnist.write_idx(str(tmp_path / "x"), a)
    np.testing.assert_array_equal(jax_fmnist._read_idx(str(tmp_path / "x")), a)
    np.testing.assert_array_equal(fmnist._read_idx(str(tmp_path / "x")), a)


@pytest.mark.parametrize("seed,n", [(777, 512), (42, 64), (0, 9)])
def test_synthetic_stand_in_is_bit_identical(tmp_path, seed, n):
    for train in (True, False):  # seed + train: the splits differ
        p = fmnist.load_fmnist_arrays(str(tmp_path), train, synthetic=True, synthetic_n=n,
                                      seed=seed)
        j = jax_fmnist.load_fmnist_arrays(str(tmp_path), train, synthetic=True, synthetic_n=n,
                                          seed=seed)
        assert p[0].dtype == np.float32 and len(p[0]) == (n if train else n // 4)
        for a, b in zip(p, j):
            np.testing.assert_array_equal(a, b)
    port = fmnist.get_fmnist(str(tmp_path), batch_size=8, seed=seed, synthetic=True, synthetic_n=n)
    jax_ = jax_fmnist.get_fmnist(str(tmp_path), batch_size=8, seed=seed, synthetic=True,
                                 synthetic_n=n)
    for p, j in zip(port[:2], jax_[:2]):
        for (px, py), (jx, jy) in zip(p.iter_epoch(1), j.iter_epoch(1)):
            np.testing.assert_array_equal(px, jx)
            np.testing.assert_array_equal(py, jy)


def test_quarter_crop_views_are_ul_ur_ll_lr():
    img = np.arange(28 * 28, dtype=np.uint8).reshape(1, 28, 28)
    x = fmnist.quarter_crop(img)
    np.testing.assert_array_equal(x, jax_fmnist.quarter_crop(img))
    for v, (r, c) in enumerate(((0, 0), (0, 14), (14, 0), (14, 14))):
        np.testing.assert_array_equal(x[0, v, 0], img[0, r:r + 14, c:c + 14] / np.float32(255.0))
    with pytest.raises(ValueError, match="28 x 28"):
        fmnist.quarter_crop(np.zeros((1, 27, 28), np.uint8))


def _jax_perms(key, model_type, b, m):
    """The permutations JAX's data_forming_func draws from ``key``."""
    def instance(k):
        return np.stack([np.asarray(jax.random.permutation(kk, b))
                         for kk in jax.random.split(k, m)])
    if model_type == "MIMO-shuffle-instance":
        return instance(key)
    if model_type == "MIMO-shuffle-view":
        return np.asarray(jax.random.permutation(key, m))
    if model_type == "MIMO-shuffle-all":
        k1, k2 = jax.random.split(key)
        return instance(k1), np.asarray(jax.random.permutation(k2, m))
    return None


@pytest.mark.parametrize("model_type", MODEL_TYPES)
@pytest.mark.parametrize("phase", ["train", "eval"])
def test_data_forming_matches_jax_with_its_permutations(model_type, phase):
    b, m = 6, 4
    rng = np.random.default_rng(1)
    x = rng.normal(size=(b, m, 1, 3, 3)).astype(np.float32)
    y = rng.integers(0, 10, b)
    key = jax.random.key(5)
    jx, jy = jax_forming.data_forming_func(key, jnp.asarray(x), jnp.asarray(y), phase=phase,
                                           model_type=model_type)
    px, py = data_forming.data_forming_func(torch.from_numpy(x), torch.from_numpy(y),
                                            phase=phase, model_type=model_type,
                                            perms=_jax_perms(key, model_type, b, m))
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))


@pytest.mark.parametrize("model_type", ["MIMO-shuffle-instance", "MIMO-shuffle-view",
                                        "MIMO-shuffle-all"])
def test_data_forming_draws_from_the_generator(model_type):
    """From a generator: each view's rows are a permutation of the batch and
    each label follows its row; the same seed draws the same batch."""
    b, m = 8, 4
    x = torch.arange(b)[:, None, None, None, None].float().repeat(1, m, 1, 1, 1)
    x = x + 100 * torch.arange(m)[None, :, None, None, None]  # value = row + 100 x view
    y = torch.arange(b)
    px, py = data_forming.data_forming_func(x, y, phase="train", model_type=model_type,
                                            generator=torch.Generator().manual_seed(3))
    again = data_forming.data_forming_func(x, y, phase="train", model_type=model_type,
                                           generator=torch.Generator().manual_seed(3))
    assert torch.equal(px, again[0]) and torch.equal(py, again[1])
    rows, views = px[..., 0, 0, 0] % 100, px[..., 0, 0, 0] // 100
    for i in range(m):
        assert sorted(rows[:, i].tolist()) == list(range(b))
        assert len(set(views[:, i].tolist())) == 1
    assert sorted(views[0].tolist()) == list(range(m))
    assert torch.equal(py, rows.long())
    with pytest.raises(ValueError, match="generator or perms"):
        data_forming.data_forming_func(x, y, phase="train", model_type=model_type)


def test_data_forming_rejects_unknown_types_and_model_configure_is_jax():
    with pytest.raises(ValueError, match="unknown model_type"):
        data_forming.data_forming_func(torch.zeros(2, 4, 1, 2, 2), torch.zeros(2), phase="eval",
                                       model_type="MIMO")
    assert port_models.model_configure == jax_models.model_configure
    assert data_forming.MULTIVIEW_MODEL_TYPES == jax_forming.MODEL_TYPES
    assert data_forming.MODEL_TYPES == ("Vanilla", "MultiHead", "MIMO-shuffle-instance")
