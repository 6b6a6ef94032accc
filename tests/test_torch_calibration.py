"""The port's temperature scaling (``analysis/calibration.py``, numpy) and its
calibrate tool, held to the JAX package's module on the same arrays: the
fitted temperature, the NLLs, ECEs and reliability curves within 1e-6."""
import json

import numpy as np
import pytest

from multimodal_uncertainty_tpu.analysis import calibration as JC
from multimodal_uncertainty_tpu_torch.analysis import calibration as TC
from multimodal_uncertainty_tpu_torch.ops.metrics import softmax_np


def _logits(n=600, c=5, t_true=2.5, heads=None, seed=0):
    """Logits overconfident by ``t_true`` (labels drawn from softmax(base)),
    (N, C) or (N, E, C) with per-head noise."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, c)) * 2.0
    cdf = softmax_np(base).cumsum(-1)
    labels = (rng.random((n, 1)) > cdf).sum(-1)
    logits = base * t_true
    if heads:
        logits = logits[:, None, :] + rng.normal(size=(n, heads, c)) * 0.3
    return logits, labels


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif a is None or isinstance(a, str):
        assert a == b
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=0, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("heads", [None, 3])
def test_fit_and_apply_temperature_match_jax(heads):
    logits, labels = _logits(heads=heads, seed=1)
    t = TC.fit_temperature(logits, labels)
    assert abs(t - JC.fit_temperature(logits, labels)) <= 1e-6 and 1.5 < t < 4.0
    _close(TC.apply_temperature(logits, t), JC.apply_temperature(logits, t))
    flat = logits if heads is None else logits[:, 0]
    assert abs(TC.nll(flat / t, labels) - JC.nll(flat / t, labels)) <= 1e-6
    probs = TC.apply_temperature(logits, t)
    _close(TC.reliability_curve(probs, labels, 10), JC.reliability_curve(probs, labels, 10))
    with pytest.raises(ValueError):
        TC.fit_temperature(np.zeros((len(labels), 1, 1, 5)), labels)


@pytest.mark.parametrize("case", ["val only", "val and test", "calibrated ensemble"])
def test_calibration_report_matches_jax(case):
    if case == "calibrated ensemble":  # the guard's branch: the fit worsens ECE, T = 1 served
        rng = np.random.default_rng(0)
        labels = rng.integers(0, 10, 2000)
        val = rng.normal(0, 1.0, (2000, 1, 10)) + rng.normal(0, 0.2, (2000, 3, 10))
        val[np.arange(2000), :, labels] += 1.0
        args = (val, labels)
    else:
        val, val_labels = _logits(heads=2, seed=2)
        args = (val, val_labels) + (_logits(heads=2, seed=3) if case == "val and test" else ())
    rep = TC.calibration_report(*args)
    _close(rep, JC.calibration_report(*args))
    assert (rep["guard"] is None) == (case != "calibrated ensemble")
    for kw in ({"ece_before": 0.0074, "ece_after": 0.1942, "nll_before": 2.26, "nll_after": 2.18},
               {"ece_before": 0.2, "ece_after": 0.02, "nll_before": 2.0, "nll_after": 1.5}):
        assert TC.recommend_temperature(0.2, **kw) == JC.recommend_temperature(0.2, **kw)


def test_calibrate_cli_matches_jax(tmp_path, capsys):
    from multimodal_uncertainty_tpu_torch.tools import calibrate

    val, val_labels = _logits(heads=2, seed=4)
    test, test_labels = _logits(heads=2, seed=5)
    paths = {}
    for name, arr in (("val_predictions", val), ("val_labels", val_labels),
                      ("test_predictions", test), ("test_labels", test_labels)):
        paths[name] = str(tmp_path / f"{name}.npy")
        np.save(paths[name], arr)
    csv_path = str(tmp_path / "reliability.csv")
    rep = calibrate.main([f"--{k}={v}" for k, v in paths.items()]
                         + ["--reliability_csv", csv_path])
    printed = json.loads(capsys.readouterr().out)
    ref = JC.calibration_report(val, val_labels, test, test_labels)
    curve = ref.pop("reliability_after")
    _close({k: printed[k] for k in ref}, ref)
    assert printed["eval_split"] == "test" and rep["serve_with"] == printed["serve_with"]
    assert "--temperature" in printed["serve_with"]
    rows = np.loadtxt(csv_path, delimiter=",", skiprows=1)
    np.testing.assert_allclose(rows[:, 2], curve["confidence"], atol=1e-6, equal_nan=True)
    assert rows[:, 4].sum() == test_labels.size
    with pytest.raises(SystemExit):
        calibrate.main(["--val_predictions", paths["val_predictions"], "--val_labels",
                        paths["val_labels"], "--test_labels", paths["test_labels"]])
