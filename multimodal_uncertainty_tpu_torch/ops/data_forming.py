"""Two-modality MIMO / multi-head batch forming (port of
``ops/data_forming.py:103-133``, ``data_forming_func_transformer``).

At train:
  - ``Vanilla``:               y -> (B, 1)
  - ``MultiHead``:             y -> (B, 2)
  - ``MIMO-shuffle-instance``: independent batch permutations of the image
    and the text stream, labels following each stream; y -> (B, 2).
At eval every strategy is the identity.

The two permutations are drawn with ``torch.randperm`` from an explicit CPU
``torch.Generator`` (the trainer seeds one per (epoch, batch)), or passed in
as ``perms``, so a test can inject the permutations that the JAX package drew.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

MODEL_TYPES = ("Vanilla", "MultiHead", "MIMO-shuffle-instance")


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
        idx_img, idx_txt = (
            (p if isinstance(p, torch.Tensor) else torch.from_numpy(np.array(p, np.int64)))
            .long().to(img.device) for p in perms)
        return (img[idx_img], txt[idx_txt]), torch.stack([y[idx_img], y[idx_txt]], dim=1)
    raise ValueError(f"model_type {model_type!r} not supported on the two-modality path")
