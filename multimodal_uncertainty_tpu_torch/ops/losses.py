"""Loss functions for multi-head / MIMO ensembles (port of ``ops/losses.py``).

Every fusion model's loss flattens the (B, E, C) head logits to (B*E, C)
against flattened labels during training (one CE term per ensemble member),
and averages the *logits* over heads before a single CE at eval.
"""
from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy over integer labels, computed in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).mean()


def mimo_cross_entropy(y_hat: torch.Tensor, y: torch.Tensor, *, eval: bool = False) -> torch.Tensor:
    """CE over head-flattened logits (train) or head-mean logits (eval).

    y_hat: (B, E, C); y: (B, E) at train (already formed), (B,) at eval."""
    y = y.reshape(-1)
    if not eval:
        y_hat = y_hat.reshape(-1, y_hat.shape[-1])
    else:
        y_hat = y_hat.mean(dim=1)
    return softmax_cross_entropy(y_hat, y)


def plain_cross_entropy(y_hat: torch.Tensor, y: torch.Tensor, *, eval: bool = False) -> torch.Tensor:
    """Single-head CE, MMBT's loss (reference ``src/mmbt.py:261-262``)."""
    del eval
    return softmax_cross_entropy(y_hat, y.reshape(-1))
