"""MIMO / multi-head batch forming (port of ``ops/data_forming.py``).

Multi-view (5-D) path ``data_forming_func`` (x: (B, M, C, H, W), y: (B,)),
the FashionMNIST round's six strategies (``MULTIVIEW_MODEL_TYPES``):
  - ``single-model-weight-sharing``: x -> (B*M, C, H, W), y -> (B*M,), in
    *every* phase (the reference has no phase guard there);
  - at train: ``Vanilla`` y -> (B, 1); ``MultiHead`` y -> (B, M);
    ``MIMO-shuffle-instance`` an independent batch permutation per view,
    labels following their view, y -> (B, M); ``MIMO-shuffle-view`` the
    view axis permuted, y -> (B, M); ``MIMO-shuffle-all`` the instance
    shuffle, then the view permutation of both x and y;
  - at eval the other five are the identity.

Two-modality path ``data_forming_func_transformer`` (port of :103-133,
x = (img, txt)) at train:
  - ``Vanilla``:               y -> (B, 1)
  - ``MultiHead``:             y -> (B, 2)
  - ``MIMO-shuffle-instance``: independent batch permutations of the image
    and the text stream, labels following each stream; y -> (B, 2).
At eval every strategy is the identity.

The permutations are drawn with ``torch.randperm`` from an explicit CPU
``torch.Generator`` (the trainer seeds one per (epoch, batch)), or passed in
as ``perms``, so a test can inject the permutations that the JAX package drew.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

MODEL_TYPES = ("Vanilla", "MultiHead", "MIMO-shuffle-instance")  # the two-modality path's
MULTIVIEW_MODEL_TYPES = ("Vanilla", "MIMO-shuffle-instance", "MIMO-shuffle-view", "MultiHead",
                         "MIMO-shuffle-all", "single-model-weight-sharing")


def _index(p, device) -> torch.Tensor:
    """A permutation (tensor, array or list) as an int64 tensor on ``device``."""
    t = p if isinstance(p, torch.Tensor) else torch.from_numpy(np.array(p, np.int64))
    return t.long().to(device)


def data_forming_func(
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    phase: str,
    model_type: str,
    generator: Optional[torch.Generator] = None,
    perms=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-view batch forming (reference ``src/dataset.py:56-101``).

    ``perms`` replaces the draws from ``generator``: the (M, B) index matrix
    of ``MIMO-shuffle-instance`` (row i the batch order of view i), the view
    permutation (M,) of ``MIMO-shuffle-view``, the pair (index matrix, view
    permutation) of ``MIMO-shuffle-all``."""
    if model_type not in MULTIVIEW_MODEL_TYPES:
        raise ValueError(f"unknown model_type {model_type!r}")
    b, m = x.shape[0], x.shape[1]
    if model_type == "single-model-weight-sharing":
        return x.reshape((b * m,) + tuple(x.shape[2:])), y[:, None].repeat(1, m).reshape(-1)
    if phase != "train":
        return x, y
    if model_type == "Vanilla":
        return x, y[:, None]
    if model_type == "MultiHead":
        return x, y[:, None].repeat(1, m)
    if perms is None:
        if generator is None:
            raise ValueError(f"{model_type} needs a generator or perms at train")
        idx = (torch.stack([torch.randperm(b, generator=generator) for _ in range(m)])
               if model_type != "MIMO-shuffle-view" else None)
        view = (torch.randperm(m, generator=generator)
                if model_type != "MIMO-shuffle-instance" else None)
        perms = {"MIMO-shuffle-instance": idx, "MIMO-shuffle-view": view,
                 "MIMO-shuffle-all": (idx, view)}[model_type]
    if model_type == "MIMO-shuffle-instance":
        return _shuffle_instance(x, y, _index(perms, x.device))
    if model_type == "MIMO-shuffle-view":
        return x[:, _index(perms, x.device)], y[:, None].repeat(1, m)
    idx, view = (_index(p, x.device) for p in perms)  # MIMO-shuffle-all
    x, y = _shuffle_instance(x, y, idx)
    return x[:, view], y[:, view]


def _shuffle_instance(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor):
    """An independent batch permutation per view: out[b, i] = x[idx[i, b], i],
    labels (B, M) following their view."""
    views = torch.arange(x.shape[1], device=x.device)[None, :]  # (1, M)
    return x[idx.t(), views], y[idx.t()]


def data_forming_func_transformer(
    x: Tuple[torch.Tensor, torch.Tensor],
    y: torch.Tensor,
    *,
    phase: str,
    model_type: str,
    generator: Optional[torch.Generator] = None,
    perms: Optional[Sequence] = None,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    img, txt = x
    if phase != "train":
        return (img, txt), y
    if model_type == "Vanilla":
        return (img, txt), y[:, None]
    if model_type == "MultiHead":
        return (img, txt), y[:, None].repeat(1, 2)
    if model_type == "MIMO-shuffle-instance":
        if perms is None:
            if generator is None:
                raise ValueError("MIMO-shuffle-instance needs a generator or perms at train")
            perms = (torch.randperm(img.shape[0], generator=generator),
                     torch.randperm(txt.shape[0], generator=generator))
        idx_img, idx_txt = (_index(p, img.device) for p in perms)
        return (img[idx_img], txt[idx_txt]), torch.stack([y[idx_img], y[idx_txt]], dim=1)
    raise ValueError(f"model_type {model_type!r} not supported on the two-modality path")
