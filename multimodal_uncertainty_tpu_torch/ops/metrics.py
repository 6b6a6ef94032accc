"""Metrics (port of ``ops/metrics.py``): accuracy on the device, AUROC and
ECE on the host in numpy.

``accuracy`` uses the training head layout during training (the (B, E, C)
logits flattened to (B*E, C) rows) and head-averaged logits at eval, in
percent. ``binary_auroc`` is the Mann-Whitney rank statistic with average
ranks for ties. ``expected_calibration_error`` uses equal-width confidence
bins, |conf - acc| weighted by bin mass.
"""
from __future__ import annotations

import numpy as np
import torch


def accuracy(y_pred: torch.Tensor, y_true: torch.Tensor, *, eval: bool,
             dummy_dim: bool = True) -> torch.Tensor:
    """Percent accuracy with the train/eval head layout."""
    if dummy_dim:
        if not eval:
            y_pred = y_pred.reshape(-1, y_pred.shape[-1])
            y_true = y_true.reshape(-1)
        else:
            y_pred = y_pred.mean(dim=1)
    pred = y_pred.argmax(dim=-1)
    return (pred == y_true.reshape(-1)).float().mean() * 100.0


def binary_auroc(labels: np.ndarray, scores: np.ndarray) -> float:
    """AUROC for binary labels via the Mann-Whitney U rank statistic."""
    labels = np.asarray(labels).reshape(-1).astype(np.int64)
    scores = np.asarray(scores).reshape(-1).astype(np.float64)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("binary_auroc needs both classes present")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    ranks = np.empty_like(scores)
    base = np.arange(1, scores.size + 1, dtype=np.float64)
    i = 0
    while i < scores.size:  # average ranks over ties (1-indexed)
        j = i
        while j + 1 < scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = base[i:j + 1].mean()
        i = j + 1
    u = ranks[labels == 1].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def expected_calibration_error(probs: np.ndarray, labels: np.ndarray, n_bins: int = 15) -> float:
    """ECE with equal-width confidence bins over max-prob predictions."""
    probs = np.asarray(probs, dtype=np.float64)
    labels = np.asarray(labels).reshape(-1)
    conf = probs.max(axis=-1)
    correct = (probs.argmax(axis=-1) == labels).astype(np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    ece = 0.0
    for lo, hi in zip(edges[:-1], edges[1:]):
        in_bin = (conf > lo) & (conf <= hi) if lo > 0 else (conf >= lo) & (conf <= hi)
        if in_bin.any():
            ece += in_bin.mean() * abs(correct[in_bin].mean() - conf[in_bin].mean())
    return float(ece)


def softmax_np(x: np.ndarray) -> np.ndarray:
    """Numerically stable numpy softmax over the last axis."""
    x = np.asarray(x, dtype=np.float64)
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)
