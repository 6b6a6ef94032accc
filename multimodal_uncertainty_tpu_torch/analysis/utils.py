"""Analysis helpers the robustness tables use (port of part of
``analysis/utils.py``, the reference's ``notebooks/utils.py``; numpy only)."""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def _pearsonr(x: np.ndarray, y: np.ndarray) -> float:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    xc = x - x.mean()
    yc = y - y.mean()
    denom = np.sqrt((xc * xc).sum() * (yc * yc).sum())
    return float((xc * yc).sum() / denom) if denom else float("nan")


def get_correlation(labels, ori, image, text, image_correspondence,
                    text_correspondence) -> dict:
    """Pearson r between the experimental Δp (modality-ablated minus full)
    and the mean control Δp (reference ``notebooks/utils.py:26-34``)."""

    def correlation(exp, control):
        x = exp - ori
        y = (control - np.expand_dims(ori, 1)).mean(1)
        return _pearsonr(x, y)

    return {
        "image": correlation(image, image_correspondence),
        "text": correlation(text, text_correspondence),
    }


def load_robustness_experiment_results(
    checkpoint_name: str, phase: str, exp: str, dataset: str,
    results_dir: str = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference ``notebooks/utils.py:157-164``."""
    path = results_dir or os.environ["RESULTS_DIR"]
    predictions = np.load(
        os.path.join(
            path, dataset, exp,
            f"robustness_{checkpoint_name}_predictions_{phase}.npy",
        )
    )
    labels = np.load(
        os.path.join(
            path, dataset, exp, f"robustness_{checkpoint_name}_labels_{phase}.npy"
        )
    )
    return predictions, labels
