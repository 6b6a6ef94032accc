"""Robustness-sweep tables: ACC (Food-101), AUROC (Hateful-Memes), + ECE
(port of ``analysis/robustness_tables.py``, numpy and pandas only).

Ports ``notebooks/food101_robustness.py:24-77`` and
``notebooks/hatefulmeme_robustness.py:22-41,105-112,234-254``, consuming the
(S, V, [E,] C) prediction tensors with the column contract: 0 full,
1 image-only, 2 text-only, 3..3+R image controls, 3+R..3+2R text controls.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from multimodal_uncertainty_tpu_torch.ops.metrics import (
    binary_auroc,
    expected_calibration_error,
    softmax_np as softmax,
)


def process_predictions_food101(predictions, labels, mmbt=False, n_repeats=20):
    """True-class probabilities per variant group (reference
    ``food101_robustness.py:24-44``)."""
    r = n_repeats
    ori = softmax(predictions[:, 0])
    image = softmax(predictions[:, 1])
    text = softmax(predictions[:, 2])
    image_corr = softmax(predictions[:, 3 : 3 + r])
    text_corr = softmax(predictions[:, 3 + r :])

    if not mmbt:  # head axis present: ensemble-mean probabilities
        ori, image, text = ori.mean(1), image.mean(1), text.mean(1)
        image_corr, text_corr = image_corr.mean(2), text_corr.mean(2)

    idx = np.arange(len(labels))
    ori = ori[idx, labels]
    image = image[idx, labels]
    text = text[idx, labels]
    image_corr = image_corr[idx[:, None], np.arange(r)[None, :], labels[:, None]]
    text_corr = text_corr[idx[:, None], np.arange(text_corr.shape[1])[None, :],
                          labels[:, None]]
    return labels, ori, image, text, image_corr, text_corr


def process_predictions_hatefulmeme(predictions, labels, n_repeats=20):
    """Positive-class head-mean probabilities per variant group (reference
    ``hatefulmeme_robustness.py:105-112``)."""
    r = n_repeats
    ori = softmax(predictions[:, 0]).mean(1)[:, 1]
    image = softmax(predictions[:, 1]).mean(1)[:, 1]
    text = softmax(predictions[:, 2]).mean(1)[:, 1]
    image_corr = softmax(predictions[:, 3 : 3 + r]).mean(2)[:, :, 1]
    text_corr = softmax(predictions[:, 3 + r :]).mean(2)[:, :, 1]
    return labels, ori, image, text, image_corr, text_corr


def acc_table(predictions, labels, mmbt=False, n_repeats=20):
    """Per-variant accuracy table (reference ``food101_robustness.py:46-77``).
    Returns a pandas DataFrame with 'variants' and 'ACC' columns."""
    import pandas as pd

    r = n_repeats
    if mmbt:
        ori = predictions[:, 0, :].argmax(-1)
        image = predictions[:, 1, :].argmax(-1)
        text = predictions[:, 2, :].argmax(-1)
        image_corr = predictions[:, 3 : 3 + r, :].argmax(-1)
        text_corr = predictions[:, 3 + r :, :].argmax(-1)
    else:
        ori = predictions[:, 0].mean(1).argmax(-1)
        image = predictions[:, 1].mean(1).argmax(-1)
        text = predictions[:, 2].mean(1).argmax(-1)
        image_corr = predictions[:, 3 : 3 + r].mean(2).argmax(-1)
        text_corr = predictions[:, 3 + r :].mean(2).argmax(-1)

    image_control = (image_corr == np.expand_dims(labels, 1)).mean(0) * 100
    text_control = (text_corr == np.expand_dims(labels, 1)).mean(0) * 100

    rows = [
        ("full", (ori == labels).mean() * 100),
        ("image", (image == labels).mean() * 100),
        ("text", (text == labels).mean() * 100),
    ]
    rows += [("image_control", a) for a in image_control]
    rows += [("text_control", a) for a in text_control]
    return pd.DataFrame(rows, columns=["variants", "ACC"])


def auc_table(labels, ori, image, text, image_corr, text_corr):
    """Per-variant AUROC table (reference
    ``hatefulmeme_robustness.py:22-41``)."""
    import pandas as pd

    rows = [
        ("full", binary_auroc(labels, ori)),
        ("image", binary_auroc(labels, image)),
        ("text", binary_auroc(labels, text)),
    ]
    rows += [
        ("image_control", binary_auroc(labels, image_corr[:, i]))
        for i in range(image_corr.shape[1])
    ]
    rows += [
        ("text_control", binary_auroc(labels, text_corr[:, i]))
        for i in range(text_corr.shape[1])
    ]
    return pd.DataFrame(rows, columns=["variants", "AUC"])


def ece_table(predictions, labels, n_repeats=20, n_bins=15):
    """Per-variant ECE table — calibration extension beyond reference parity
    (north-star metric)."""
    import pandas as pd

    r = n_repeats

    def probs(v):
        p = softmax(predictions[:, v])
        return p.mean(1) if p.ndim == 3 else p

    rows = [
        ("full", expected_calibration_error(probs(0), labels, n_bins)),
        ("image", expected_calibration_error(probs(1), labels, n_bins)),
        ("text", expected_calibration_error(probs(2), labels, n_bins)),
    ]
    for i in range(r):
        rows.append(
            ("image_control",
             expected_calibration_error(probs(3 + i), labels, n_bins))
        )
        rows.append(
            ("text_control",
             expected_calibration_error(probs(3 + r + i), labels, n_bins))
        )
    return pd.DataFrame(rows, columns=["variants", "ECE"])


def ensemble_overtime(
    epochs_to_ensemble, phase, exp, dataset, results_dir=None
) -> Tuple[float, list]:
    """Checkpoint-ensemble AUROC over a range of epochs (reference
    ``hatefulmeme_robustness.py:234-254``)."""
    from multimodal_uncertainty_tpu_torch.analysis.utils import (
        load_robustness_experiment_results,
    )

    preds, per_epoch = [], []
    labels = None
    for epoch in epochs_to_ensemble:
        predictions, labels = load_robustness_experiment_results(
            f"model_epoch_{epoch}", phase, exp, dataset, results_dir
        )
        _, ori, *_ = process_predictions_hatefulmeme(predictions, labels)
        per_epoch.append(binary_auroc(labels, ori))
        preds.append(ori)
    ensemble = np.asarray(preds).mean(0)
    return binary_auroc(labels, ensemble), per_epoch


def epoch_wise_analysis(
    phase, exp, epochs, dataset, *, mmbt=False, results_dir=None, n_repeats=20
):
    """Per-epoch robustness tables + dp correlations (reference
    ``food101_robustness.py:80-126`` / ``hatefulmeme_robustness.py:114-155``).

    Returns (results_df, corr_df): the per-variant metric table (ACC or AUC
    column depending on dataset) stacked over epochs, and the image/text
    dp-correlation trajectory indexed by epoch.
    """
    import pandas as pd

    from multimodal_uncertainty_tpu_torch.analysis.utils import (
        get_correlation,
        load_robustness_experiment_results,
    )

    hateful = "hateful" in dataset
    results, results_corr = [], []
    for epoch in epochs:
        checkpoint_name = f"model_epoch_{epoch}"
        try:
            predictions, labels = load_robustness_experiment_results(
                checkpoint_name, phase, exp, dataset, results_dir
            )
        except FileNotFoundError:
            print(f"Checkpoint {checkpoint_name} not found")
            continue

        if hateful:
            outcomes = process_predictions_hatefulmeme(
                predictions, labels, n_repeats=n_repeats
            )
            df = auc_table(*outcomes)
        else:
            outcomes = process_predictions_food101(
                predictions, labels, mmbt=mmbt, n_repeats=n_repeats
            )
            df = acc_table(predictions, labels, mmbt=mmbt, n_repeats=n_repeats)
        df["epoch"] = epoch
        results.append(df)

        corr = get_correlation(*outcomes)
        corr["epoch"] = epoch
        results_corr.append(corr)

    if not results:
        return None, None
    results = pd.concat(results, ignore_index=True)
    corr_df = pd.DataFrame(results_corr).set_index("epoch")
    return results, corr_df
