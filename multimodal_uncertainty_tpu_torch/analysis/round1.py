"""The FashionMNIST round's analysis (port of ``analysis/round1.py``; reference
``notebooks/analysis_round_1.py``), numpy only: head diversity as Kendall's
tau between the heads' muted top-k predictions, per-head and ensemble
accuracy, and accuracy with each view missing.

Kendall's tau is tau-b (ties counted, scipy's default), computed in
O(n log n): the discordant pairs are the inversions of the y ranks once the
pairs are sorted by x, counted level by level of a merge sort in numpy.
"""
from __future__ import annotations

import itertools
from typing import List, Sequence

import numpy as np


def trunk_pred_top(pred: np.ndarray, test_cls, top: int, mute_true: bool = False) -> np.ndarray:
    """Keep each row's top-``top`` logits and zero the rest; with
    ``mute_true`` the true class's logit is zeroed first (reference
    ``:74-84``; the threshold is taken from the row before muting)."""
    pred_ = []
    for i in range(len(pred)):
        p = pred[i].copy()
        if mute_true:
            p[test_cls[i]] = 0
        value = np.partition(pred[i].flatten(), -top)[-top]
        pred_.append([j if j >= value else 0 for j in p])
    return np.array(pred_)


def _dense_ranks(sorted_values: np.ndarray) -> np.ndarray:
    return np.r_[True, sorted_values[1:] != sorted_values[:-1]].cumsum(dtype=np.int64)


def _inversions(a: np.ndarray) -> int:
    """Pairs i < j with a[i] > a[j], by a bottom-up merge sort: at each
    level every right half-block's values are located in its sorted left
    half-block (one ``searchsorted`` over all blocks, keyed by block)."""
    n = a.size
    s = a.astype(np.int64)
    big = int(s.max()) + 1 if n else 1
    idx = np.arange(n)
    inv, w = 0, 1
    while w < n:
        block = idx // (2 * w)
        left = idx % (2 * w) < w
        l_keys = block[left] * big + s[left]  # ascending: each half-block is sorted
        r_block = block[~left]
        ends = np.searchsorted(l_keys, (r_block + 1) * big, "left")
        inv += int((ends - np.searchsorted(l_keys, r_block * big + s[~left], "right")).sum())
        s = np.sort(block * big + s) - block * big  # merge each pair of half-blocks
        w *= 2
    return inv


def kendall_tau(x, y) -> float:
    """Kendall's tau-b of two equally long arrays (flattened), as
    ``scipy.stats.kendalltau(x, y).statistic``; nan when either is constant."""
    x, y = np.asarray(x).ravel(), np.asarray(y).ravel()
    if x.size != y.size:
        raise ValueError(f"arrays differ in size: {x.size} and {y.size}")
    perm = np.argsort(y, kind="mergesort")
    x, y = x[perm], _dense_ranks(y[perm])
    perm = np.argsort(x, kind="mergesort")  # stable: equal x keep y ascending
    x, y = _dense_ranks(x[perm]), y[perm]
    dis = _inversions(y)
    obs = np.r_[True, (x[1:] != x[:-1]) | (y[1:] != y[:-1]), True]
    cnt = np.diff(np.nonzero(obs)[0]).astype(np.int64)
    ntie = int((cnt * (cnt - 1) // 2).sum())  # pairs tied in both

    def ties(ranks):
        c = np.bincount(ranks).astype(np.int64)
        return int((c * (c - 1) // 2).sum())

    xtie, ytie = ties(x), ties(y)
    tot = x.size * (x.size - 1) // 2
    if xtie == tot or ytie == tot:
        return float("nan")
    con_minus_dis = tot - xtie - ytie + ntie - 2 * dis
    tau = con_minus_dis / np.sqrt(tot - xtie) / np.sqrt(tot - ytie)
    return float(min(1.0, max(-1.0, tau)))


def subnetwork_kendalltau(preds_muted: Sequence[np.ndarray]) -> np.ndarray:
    """Kendall's tau of every pair of heads' muted top-k predictions, in
    ``itertools.combinations`` order (reference ``:86-89``)."""
    return np.array([kendall_tau(x, y) for x, y in itertools.combinations(preds_muted, 2)])


def accuracy_breakdown(predictions: np.ndarray, labels: np.ndarray) -> dict:
    """Ensemble (head-mean) and per-head accuracy from an (S, M, C) dump
    (reference ``:99-105``)."""
    acc_overall = float(np.equal(np.argmax(predictions.mean(1), 1), labels).mean())
    acc_heads = [float((np.argmax(predictions[:, i, :], 1) == labels).mean())
                 for i in range(predictions.shape[1])]
    return {"accuracy_overall": acc_overall, "accuracy_viewwise": acc_heads}


def head_diversity(predictions: np.ndarray, labels: np.ndarray, top: int = 5):
    """(mean, all) pairwise Kendall's tau of the heads' top-``top``
    predictions with the true class muted (reference ``:107-113``)."""
    preds_muted = [trunk_pred_top(predictions[:, i, :], labels, top, mute_true=True)
                   for i in range(predictions.shape[1])]
    taus = subnetwork_kendalltau(preds_muted)
    return float(taus.mean()), taus


def missing_view_accuracy(robustness_preds: np.ndarray, labels: np.ndarray) -> List[float]:
    """Head-mean accuracy with each view missing, from the (M_, S, M, C)
    sweep (reference ``:152-159``)."""
    return [float((np.argmax(robustness_preds[i].mean(1), 1) == labels).mean())
            for i in range(robustness_preds.shape[0])]
