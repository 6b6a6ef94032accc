"""FashionMNIST missing-view robustness sweep (port of
``evals/robustness_fmnist.py``; reference ``eval_robustness.py``).

For each view i the sweep ablates it and predicts again: the view is zeroed,
or under weight-sharing dropped (the reference's ``:100-115``), the other
three views folded into the batch. Where the reference makes M passes over
the loader, the four leave-one-out variants of a batch are stacked on the
batch axis and run as one forward (on the card the MIMO transformer's
attention is one launch of 4 x B rows a layer). The output is variant-major,
(M_, S, M, C), saved as ``{ckpt}_predictions_robustness.npy`` with the labels
as ``{ckpt}_labels.npy``; weight-sharing saves the labels repeated once per
kept view, as the reference saves its formed labels.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from multimodal_uncertainty_tpu_torch.evals.artifacts import concat_maybe_memmap

M = 4  # views


def sweep_batch(model: torch.nn.Module, x: torch.Tensor, model_type: str) -> torch.Tensor:
    """One batch's four leave-one-out variants in one forward: (B, M, C, H,
    W) -> (M_, B, E, C) logits, or (M_, B, M - 1, C) under weight-sharing."""
    b = x.shape[0]
    if model_type != "single-model-weight-sharing":
        keep = (~torch.eye(M, dtype=torch.bool, device=x.device)).to(x.dtype)  # (M_, M)
        xs = x[None] * keep[:, None, :, None, None, None]  # view i of variant i zeroed
        out = model(xs.reshape((M * b,) + tuple(x.shape[1:])))
        return out.reshape(M, b, *out.shape[1:])
    kept = torch.stack([torch.cat([torch.arange(i), torch.arange(i + 1, M)]) for i in range(M)])
    xs = x[:, kept.to(x.device)].transpose(0, 1)  # (M_, B, M - 1, C, H, W)
    out = model(xs.reshape((M * b * (M - 1),) + tuple(x.shape[2:])))  # (M_ B (M-1), 1, C)
    return out.reshape(M, b, M - 1, out.shape[-1])


def missing_view_sweep(
    model: torch.nn.Module,
    loader,
    *,
    model_type: str,
    save_path: Optional[str] = None,
    checkpoint_name: str = "model",
):
    """Returns (outputs (M_, S, M, C) float32, labels); writes the two
    ``.npy`` files when ``save_path`` is given. ``model`` (MIMO ResNet or
    transformer) runs in eval mode without gradients on the device its
    weights lie on; ``loader`` yields (x (B, 4, 1, 14, 14), y) numpy
    batches (``data/fmnist.py``)."""
    device = next(model.parameters()).device
    model.eval()
    outputs, labels = [], []
    with torch.no_grad():
        for x, y in loader:
            out = sweep_batch(model, torch.from_numpy(np.asarray(x)).to(device), model_type)
            outputs.append(out.float().cpu().numpy())
            y = np.asarray(y)
            labels.append(np.repeat(y, M - 1) if model_type == "single-model-weight-sharing"
                          else y)
    pred_path = (os.path.join(save_path, f"{checkpoint_name}_predictions_robustness.npy")
                 if save_path is not None else None)
    outputs = concat_maybe_memmap(outputs, axis=1, path=pred_path)
    labels = np.concatenate(labels, axis=0)
    if save_path is not None:
        os.makedirs(save_path, exist_ok=True)
        np.save(os.path.join(save_path, f"{checkpoint_name}_labels.npy"), labels)
    return outputs, labels
