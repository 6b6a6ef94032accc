"""Train and eval steps (port of ``training/steps.py:22-201``).

A step is MIMO data forming, forward, loss, backward, the optimizer update
and the metrics, run eagerly on the model's device. The fusion family trains
with no gradient accumulation (``train.py:696-699``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """Uniform adapter between a model family and the trainer.

    model: the ``nn.Module``; called as ``model(x)``
    loss_fn(logits, y, eval) -> scalar
    data_forming(generator, x, y, phase) -> (x, y)  (None = identity)
    metric_fns: (name, fn(logits, y, eval)) pairs, computed on the device
    """

    model: nn.Module
    loss_fn: Callable
    data_forming: Optional[Callable] = None
    metric_fns: Sequence = ()


def to_device(batch, device) -> Tuple:
    """A loader's numpy ``((img, txt), y)`` -> tensors on ``device``."""
    (img, txt), y = batch

    def put(a):
        return torch.as_tensor(np.asarray(a)).to(device, non_blocking=True)

    return (put(img), put(txt)), put(y)


def train_step(bundle: ModelBundle, optimizer, x, y,
               generator: Optional[torch.Generator] = None) -> dict:
    """One optimizer step; returns the loss and metrics as device scalars."""
    bundle.model.train()
    if bundle.data_forming is not None:
        x, y = bundle.data_forming(generator, x, y, "train")
    logits = bundle.model(x)
    loss = bundle.loss_fn(logits, y, eval=False)
    optimizer.zero_grad()
    loss.backward()
    optimizer.update()
    logits = logits.detach()
    metrics = {name: fn(logits, y, eval=False) for name, fn in bundle.metric_fns}
    return {"loss": loss.detach(), **metrics}


@torch.inference_mode()
def eval_step(bundle: ModelBundle, x, y):
    """(logs, preds, y): loss and metrics on the head-mean predictions
    (the logits themselves for a model without an ensemble axis)."""
    bundle.model.eval()
    if bundle.data_forming is not None:
        x, y = bundle.data_forming(None, x, y, "eval")
    logits = bundle.model(x)
    loss = bundle.loss_fn(logits, y, eval=True)
    metrics = {name: fn(logits, y, eval=True) for name, fn in bundle.metric_fns}
    preds = logits.mean(dim=1) if logits.ndim == 3 else logits
    return {"loss": loss, **metrics}, preds, y
