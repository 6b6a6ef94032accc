"""Guided and random ensemble-diversity training signals (port of
``ops/diversity.py``).

The reference ships only vestigial gin configs for these (``training_guided.gin``,
``training_random.gin``); its diversity comes from the MIMO shuffles alone. The
JAX package, and this port, give the intent a knob, ``train --diversity``:

* ``guided``: a regulariser, the mean pairwise cosine similarity of the heads'
  softmax distributions with the true class muted. Minimising it pushes the
  heads to disagree on their errors while the cross-entropy keeps them right.
* ``random``: the unguided baseline, the muted distributions' correlation with
  random unit directions: the same gradient scale with no direction.
* ``none``: the reference's training, the default.

Plain PyTorch on (B, E, C) logits; there is no kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F

DIVERSITY_KINDS = ("none", "guided", "random")


def muted_probs(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Softmax over the classes with the true class's probability zeroed.
    logits (B, E, C); y (B,) or (B, E) (then its column 0)."""
    if y.ndim == 2:
        y = y[:, 0]
    p = torch.softmax(logits.float(), dim=-1)
    mask = F.one_hot(y.long(), logits.shape[-1]).to(p.dtype)  # (B, C)
    return p * (1.0 - mask[:, None, :])


def _unit(t: torch.Tensor) -> torch.Tensor:
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)


def guided_diversity_penalty(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean pairwise cosine similarity of the heads' muted distributions, in
    [-1, 1]; lower is more diverse. 0 for one head."""
    e = logits.shape[1]
    if e < 2:
        return logits.new_zeros((), dtype=torch.float32)
    pn = _unit(muted_probs(logits, y))  # (B, E, C)
    sim = torch.einsum("bec,bfc->bef", pn, pn)
    off_diag = sim * (1.0 - torch.eye(e, device=sim.device, dtype=sim.dtype))[None]
    return off_diag.sum(dim=(1, 2)).mean() / (e * (e - 1))


def apply_diversity(loss: torch.Tensor, logits: torch.Tensor, y: torch.Tensor,
                    generator: Optional[torch.Generator] = None, *, kind: str = "none",
                    coef: float = 0.0, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The training loss with the chosen diversity signal added. ``random``
    draws its (B, E, C) standard-normal directions from ``generator`` (a CPU
    generator; the draw then moves to the logits' device), or takes them as
    ``noise``."""
    if kind == "none" or coef == 0.0:
        return loss
    if kind == "guided":
        return loss + coef * guided_diversity_penalty(logits, y)
    if kind == "random":
        p = muted_probs(logits, y)
        if noise is None:
            noise = torch.randn(p.shape, generator=generator, dtype=p.dtype)
        sim = (_unit(p) * _unit(noise.to(p.device, p.dtype))).sum(-1).mean()
        return loss + coef * sim
    raise ValueError(f"unknown diversity kind {kind!r}")
