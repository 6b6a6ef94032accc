"""Post-hoc calibration: temperature scaling and reliability diagrams (port
of the JAX package's ``analysis/calibration.py``, numpy only).

Temperature scaling (Guo et al. 2017): fit one scalar T on the validation
logits by NLL and divide the logits by T everywhere after. Accuracy and
argmax are unchanged; only confidence moves. The functions consume the
``eval_prediction_saving`` dumps: per-head logits (S, E, C) and labels (S,).
Serve the result with ``predict --temperature`` (baked into ``--export``
artifacts too).

The fit minimises NLL, not ECE. For the usual overconfident trained network
both improve together; for an underconfident or near-random model (a
one-epoch smoke run) the NLL-optimal T sharpens the distribution and max-prob
ECE can get worse while NLL still improves. :func:`calibration_report`
returns both before / after pairs, and :func:`recommend_temperature` serves
T = 1 unless the fit lowers ECE and buys a real NLL gain.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from multimodal_uncertainty_tpu_torch.ops.metrics import (
    expected_calibration_error,
    softmax_np,
)

_GOLDEN = (np.sqrt(5.0) - 1.0) / 2.0


def nll(logits: np.ndarray, labels: np.ndarray) -> float:
    """Mean negative log-likelihood of (N, C) logits."""
    logp = logits - logits.max(-1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
    return float(-logp[np.arange(labels.size), labels.reshape(-1)].mean())


def _ensemble_nll(head_logits: np.ndarray, labels: np.ndarray, t: float) -> float:
    """NLL of the head-mean probabilities after tempering each head —
    the MIMO eval semantics (heads average AFTER softmax here so each
    member stays a proper tempered distribution)."""
    probs = softmax_np(head_logits / t).mean(axis=1)
    return float(
        -np.log(probs[np.arange(labels.size), labels.reshape(-1)] + 1e-12).mean()
    )


def fit_temperature(
    logits: np.ndarray,
    labels: np.ndarray,
    *,
    lo: float = 0.05,
    hi: float = 20.0,
    iters: int = 80,
) -> float:
    """Fit the temperature minimizing validation NLL.

    ``logits`` is (N, C) — single-head or already head-reduced — or
    (N, E, C) per-head MIMO logits (tempered per head, probabilities
    ensemble-averaged, matching eval). Golden-section search over log T:
    the 1-D NLL is unimodal in T, no optimizer dependency needed.
    """
    logits = np.asarray(logits, np.float64)
    labels = np.asarray(labels).reshape(-1)
    if logits.ndim == 3:
        f = lambda t: _ensemble_nll(logits, labels, t)
    elif logits.ndim == 2:
        f = lambda t: nll(logits / t, labels)
    else:
        raise ValueError(f"logits must be (N, C) or (N, E, C); got {logits.shape}")

    a, b = np.log(lo), np.log(hi)
    c = b - _GOLDEN * (b - a)
    d = a + _GOLDEN * (b - a)
    fc, fd = f(np.exp(c)), f(np.exp(d))
    for _ in range(iters):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - _GOLDEN * (b - a)
            fc = f(np.exp(c))
        else:
            a, c, fc = c, d, fd
            d = a + _GOLDEN * (b - a)
            fd = f(np.exp(d))
    return float(np.exp((a + b) / 2.0))


def apply_temperature(logits: np.ndarray, t: float) -> np.ndarray:
    """Tempered probabilities; (N, E, C) inputs ensemble-average the
    per-head tempered distributions (eval-time head handling)."""
    logits = np.asarray(logits, np.float64)
    probs = softmax_np(logits / t)
    if logits.ndim == 3:
        probs = probs.mean(axis=1)
    return probs


def reliability_curve(
    probs: np.ndarray, labels: np.ndarray, n_bins: int = 15
) -> dict:
    """Equal-width reliability-diagram data over max-prob predictions:
    per-bin mean confidence, accuracy, and count (same binning as
    ``ops.metrics.expected_calibration_error``)."""
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels).reshape(-1)
    conf = probs.max(-1)
    correct = (probs.argmax(-1) == labels).astype(np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    confidence = np.full(n_bins, np.nan)
    accuracy = np.full(n_bins, np.nan)
    count = np.zeros(n_bins, np.int64)
    for i, (e_lo, e_hi) in enumerate(zip(edges[:-1], edges[1:])):
        in_bin = (
            (conf > e_lo) & (conf <= e_hi) if e_lo > 0
            else (conf >= e_lo) & (conf <= e_hi)
        )
        count[i] = int(in_bin.sum())
        if count[i]:
            confidence[i] = conf[in_bin].mean()
            accuracy[i] = correct[in_bin].mean()
    return {
        "bin_edges": edges,
        "confidence": confidence,
        "accuracy": accuracy,
        "count": count,
    }


def recommend_temperature(
    t_fit: float,
    ece_before: float,
    ece_after: float,
    nll_before: float,
    nll_after: float,
    *,
    min_nll_gain: float = 0.005,
) -> tuple:
    """Decide whether the fitted temperature should actually be deployed.

    The fit minimizes NLL, which is NOT the serving objective (max-prob
    calibration). Two regimes make the fitted T actively harmful, both seen
    in practice (the fmnist smoke drive fitted T=0.196 on an
    already-calibrated model and pushed ECE 0.0074 -> 0.194, 26x worse):

    * the fitted T DEGRADES ECE on the eval split, or
    * the NLL gain is negligible (relative improvement < ``min_nll_gain``)
      so there is no evidence the reshape helps anything.

    Returns ``(recommended_t, guard)`` — the fitted T with ``guard=None``
    when scaling is safe, else ``(1.0, reason)``.
    """
    if ece_after > ece_before:
        return 1.0, (
            f"ece_degraded: temperature scaling worsens ECE "
            f"({ece_before:.4f} -> {ece_after:.4f}); serving with T=1.0"
        )
    rel_gain = (nll_before - nll_after) / max(abs(nll_before), 1e-12)
    if rel_gain < min_nll_gain:
        return 1.0, (
            f"nll_gain_negligible: NLL improves only {rel_gain * 100.0:.3f}% "
            f"({nll_before:.4f} -> {nll_after:.4f}); serving with T=1.0"
        )
    return float(t_fit), None


def calibration_report(
    val_logits: np.ndarray,
    val_labels: np.ndarray,
    test_logits: Optional[np.ndarray] = None,
    test_labels: Optional[np.ndarray] = None,
    *,
    n_bins: int = 15,
) -> dict:
    """Fit T on validation, report ECE/NLL before vs after (on test when
    given, else on validation — the honest protocol fits and evaluates on
    different splits).

    ``recommended_temperature`` is the value to actually serve with: the
    fitted T only when it does not degrade ECE and buys a real NLL gain on
    the eval split (see :func:`recommend_temperature`); otherwise 1.0, with
    the reason in ``guard``.
    """
    t = fit_temperature(val_logits, val_labels)
    logits = val_logits if test_logits is None else test_logits
    labels = val_labels if test_labels is None else test_labels
    before = apply_temperature(logits, 1.0)
    after = apply_temperature(logits, t)
    ece_before = expected_calibration_error(before, labels, n_bins)
    ece_after = expected_calibration_error(after, labels, n_bins)
    nll_before = _report_nll(logits, labels, 1.0)
    nll_after = _report_nll(logits, labels, t)
    rec_t, guard = recommend_temperature(
        t, ece_before, ece_after, nll_before, nll_after
    )
    return {
        "temperature": t,
        "recommended_temperature": rec_t,
        "guard": guard,
        "ece_before": ece_before,
        "ece_after": ece_after,
        "nll_before": nll_before,
        "nll_after": nll_after,
        "reliability_after": reliability_curve(
            apply_temperature(logits, rec_t), labels, n_bins
        ),
    }


def _report_nll(logits: np.ndarray, labels: np.ndarray, t: float) -> float:
    logits = np.asarray(logits, np.float64)
    labels = np.asarray(labels).reshape(-1)
    if logits.ndim == 3:
        return _ensemble_nll(logits, labels, t)
    return nll(logits / t, labels)
