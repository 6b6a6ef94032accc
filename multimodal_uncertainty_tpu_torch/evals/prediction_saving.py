"""Per-head prediction dumps (port of ``evals/prediction_saving.py``;
reference ``eval_prediction_saving.py``).

One forward over the eval split: per-head logits (S, M, C) and labels (S,)
saved as ``{ckpt}_predictions.npy`` / ``{ckpt}_labels.npy``, the arrays the
round-1 analysis reads (``analysis/round1.py``). Weight-sharing's forward
runs on the views folded into the batch and its logits are folded back to
(S, 4, C).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from multimodal_uncertainty_tpu_torch.evals.artifacts import concat_maybe_memmap
from multimodal_uncertainty_tpu_torch.ops.data_forming import data_forming_func


def save_predictions(
    model: torch.nn.Module,
    loader,
    *,
    model_type: str,
    save_path: Optional[str] = None,
    checkpoint_name: str = "model",
):
    """Returns (outputs (S, M, C) float32, labels (S,)); writes the two
    ``.npy`` files when ``save_path`` is given. The batches are formed as at
    eval (``data_forming_func``) and run in eval mode without gradients on
    the device of ``model``'s weights."""
    device = next(model.parameters()).device
    model.eval()
    outputs, labels = [], []
    with torch.no_grad():
        for x, y in loader:
            b, m = x.shape[0], x.shape[1]
            xt, yt = data_forming_func(torch.from_numpy(np.asarray(x)).to(device),
                                       torch.from_numpy(np.asarray(y)), phase="eval",
                                       model_type=model_type)
            y_hat = model(xt)
            if model_type == "single-model-weight-sharing":
                y_hat = y_hat.reshape(b, m, y_hat.shape[-1])
                yt = yt.reshape(b, m)[:, 0]
            outputs.append(y_hat.float().cpu().numpy())
            labels.append(yt.numpy())
    pred_path = (os.path.join(save_path, f"{checkpoint_name}_predictions.npy")
                 if save_path is not None else None)
    outputs = concat_maybe_memmap(outputs, axis=0, path=pred_path)
    labels = np.concatenate(labels, axis=0)
    if save_path is not None:
        os.makedirs(save_path, exist_ok=True)
        np.save(os.path.join(save_path, f"{checkpoint_name}_labels.npy"), labels)
    return outputs, labels
