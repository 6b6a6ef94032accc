"""The FashionMNIST round's evals and analysis in the port against the JAX
package's, on the CPU: the missing-view sweep (``evals/robustness_fmnist.py``)
and the per-head prediction dumps (``evals/prediction_saving.py``) for the
MIMO ResNet (MIMO-shuffle-instance, Vanilla and weight-sharing) and the MIMO
transformer, their arrays and ``.npy`` files, and ``analysis/round1.py``.

The models are the JAX setups' (``setup_fashionmnist``), their weights
carried across by the converters; the batches are the seeded synthetic
stand-in through each package's ``get_fmnist``. Tolerances: logits 1e-5
absolute (fp32 summed in another order, the variants batched otherwise);
labels equal; round 1's numbers equal the JAX functions' to 1e-12 (Kendall's
tau: the port's O(n log n) count against scipy's).
"""
import jax
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.analysis import round1 as jax_round1
from multimodal_uncertainty_tpu.data.fmnist import get_fmnist as jax_get_fmnist
from multimodal_uncertainty_tpu.evals import prediction_saving as jax_saving
from multimodal_uncertainty_tpu.evals import robustness_fmnist as jax_sweep
from multimodal_uncertainty_tpu.ops.data_forming import data_forming_func as jax_forming
from multimodal_uncertainty_tpu.zoo import setup_fashionmnist as jax_setup
from multimodal_uncertainty_tpu_torch.analysis import round1
from multimodal_uncertainty_tpu_torch.data.fmnist import get_fmnist
from multimodal_uncertainty_tpu_torch.evals import prediction_saving, robustness_fmnist
from multimodal_uncertainty_tpu_torch.models.jax_import import (
    mimo_resnet_state_dict_from_jax,
    mimo_transformer_state_dict_from_jax,
)
from multimodal_uncertainty_tpu_torch.zoo import setup_fashionmnist


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the test run puts several processes on
    a few cores at once, and torch's CPU convolutions spinning on every core
    from each of them slow to a crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = [("MIMO-shuffle-instance", False), ("Vanilla", False),
         ("single-model-weight-sharing", False), ("MIMO-shuffle-instance", True)]


def _pair(model_type, transformer):
    kw = dict(model_type=model_type, transformer=transformer, multimodal_num_hidden_layers=1)
    js = jax_setup(**kw, seed_key=jax.random.key(3), attn_impl="xla")
    variables = {"params": js.state.params}
    if js.state.batch_stats is not None:
        variables["batch_stats"] = js.state.batch_stats
    variables = jax.tree_util.tree_map(np.asarray, variables)
    ts = setup_fashionmnist(**kw, device="cpu")
    convert = (mimo_transformer_state_dict_from_jax if transformer
               else mimo_resnet_state_dict_from_jax)
    ts.model.load_state_dict(convert(variables), strict=True)
    return js, variables, ts.model


def _loaders(tmp_path):
    kw = dict(datapath=str(tmp_path), batch_size=12, seed=5, synthetic=True, synthetic_n=120)
    return jax_get_fmnist(**kw)[1], get_fmnist(**kw)[1]  # the t10k split: 30 rows, unshuffled


@pytest.mark.parametrize("model_type,transformer", CASES)
def test_missing_view_sweep_matches_jax(model_type, transformer, tmp_path):
    """(M_, S, M, C) = (4, 30, 4 or 3, 10): view i zeroed in variant i, or
    dropped under weight-sharing; the port's and JAX's predictions files
    equal within 1e-5, the labels files equal (repeated per kept view under
    weight-sharing)."""
    js, variables, model = _pair(model_type, transformer)
    jloader, ploader = _loaders(tmp_path)
    ref, ref_labels = jax_sweep.missing_view_sweep(
        js.bundle.apply_fn, variables, jloader, model_type=model_type,
        save_path=str(tmp_path / "jax"), checkpoint_name="ckpt")
    got, labels = robustness_fmnist.missing_view_sweep(
        model, ploader, model_type=model_type, save_path=str(tmp_path / "port"),
        checkpoint_name="ckpt")
    ws = model_type == "single-model-weight-sharing"
    e = 1 if model_type == "Vanilla" else 4
    assert got.shape == ref.shape == (4, 30, 3 if ws else e, 10) and got.dtype == np.float32
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(labels, ref_labels)
    assert labels.shape == ((90,) if ws else (30,))
    for name in ("ckpt_predictions_robustness.npy", "ckpt_labels.npy"):
        p, j = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert p.shape == j.shape and p.dtype == j.dtype
        np.testing.assert_allclose(p, j, atol=1e-5, rtol=0)


def test_sweep_batch_zeroes_or_drops_the_view():
    """Variant i of ``sweep_batch``: view i zeroed (the others as they were),
    or under weight-sharing the three other views in order, folded into the
    batch."""
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen.append(x.clone())
            return torch.zeros(x.shape[0], 1, 10)

    x = torch.arange(2 * 4, dtype=torch.float32).reshape(2, 4, 1, 1, 1) + 1
    robustness_fmnist.sweep_batch(Probe(), x, "MIMO-shuffle-instance")
    v = seen[-1].reshape(4, 2, 4)
    for i in range(4):
        want = x.reshape(2, 4).clone()
        want[:, i] = 0
        assert torch.equal(v[i], want)
    out = robustness_fmnist.sweep_batch(Probe(), x, "single-model-weight-sharing")
    assert out.shape == (4, 2, 3, 10)
    v = seen[-1].reshape(4, 2, 3)
    for i in range(4):
        keep = [j for j in range(4) if j != i]
        assert torch.equal(v[i], x.reshape(2, 4)[:, keep])


@pytest.mark.parametrize("model_type,transformer", CASES)
def test_save_predictions_matches_jax(model_type, transformer, tmp_path):
    """(S, M, C) per-head logits and (S,) labels, weight-sharing's four views
    folded back: equal to JAX's within 1e-5, files included."""
    js, variables, model = _pair(model_type, transformer)
    jloader, ploader = _loaders(tmp_path)
    ref, ref_labels = jax_saving.save_predictions(
        js.bundle.apply_fn, variables, jloader, model_type=model_type,
        data_forming=lambda k, x, y, phase: jax_forming(k, x, y, phase=phase,
                                                        model_type=model_type),
        save_path=str(tmp_path / "jax"), checkpoint_name="ckpt")
    got, labels = prediction_saving.save_predictions(
        model, ploader, model_type=model_type, save_path=str(tmp_path / "port"),
        checkpoint_name="ckpt")
    m = 1 if model_type == "Vanilla" else 4
    assert got.shape == ref.shape == (30, m, 10) and got.dtype == np.float32
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(labels, ref_labels)
    for name in ("ckpt_predictions.npy", "ckpt_labels.npy"):
        p, j = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert p.shape == j.shape
        np.testing.assert_allclose(p, j, atol=1e-5, rtol=0)
    # the labels as loaded, int64 (JAX's pass through jnp without x64: int32)
    assert np.load(tmp_path / "port" / "ckpt_labels.npy").dtype == np.int64


def test_round1_analysis_matches_jax():
    rng = np.random.default_rng(0)
    preds = rng.normal(size=(200, 4, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 200)
    sweep = rng.normal(size=(4, 200, 4, 10)).astype(np.float32)
    for mute in (False, True):
        np.testing.assert_array_equal(round1.trunk_pred_top(preds[:, 1], labels, 3, mute),
                                      jax_round1.trunk_pred_top(preds[:, 1], labels, 3, mute))
    assert round1.accuracy_breakdown(preds, labels) == jax_round1.accuracy_breakdown(preds, labels)
    mean, taus = round1.head_diversity(preds, labels)
    jmean, jtaus = jax_round1.head_diversity(preds, labels)
    assert taus.shape == (6,)
    np.testing.assert_allclose(taus, jtaus, atol=1e-12, rtol=0)
    assert mean == pytest.approx(jmean, abs=1e-12)
    muted = [round1.trunk_pred_top(preds[:, i], labels, 5, True) for i in range(3)]
    np.testing.assert_allclose(round1.subnetwork_kendalltau(muted),
                               jax_round1.subnetwork_kendalltau(muted), atol=1e-12, rtol=0)
    assert (round1.missing_view_accuracy(sweep, labels)
            == jax_round1.missing_view_accuracy(sweep, labels))


@pytest.mark.parametrize("n,ties", [(2, 0.0), (7, 0.5), (300, 0.9), (5000, 0.3)])
def test_kendall_tau_is_scipys_tau_b(n, ties):
    from scipy import stats

    rng = np.random.default_rng(n)
    x = rng.integers(0, 20, n).astype(float)
    y = x * 0.5 + rng.normal(size=n)
    x[rng.random(n) < ties] = 0.0  # zeros, as the muted top-k rows have
    y[rng.random(n) < ties] = 0.0
    want = stats.kendalltau(x, y).statistic
    assert round1.kendall_tau(x, y) == pytest.approx(want, abs=1e-12)
    assert np.isnan(round1.kendall_tau(np.ones(5), np.arange(5)))
    with pytest.raises(ValueError, match="differ in size"):
        round1.kendall_tau(np.ones(3), np.ones(4))
