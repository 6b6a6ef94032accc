"""Train and eval steps (port of ``training/steps.py:22-201``).

A step is MIMO data forming, forward, loss, backward, the optimizer update
and the metrics, run eagerly on the model's device. The fusion family trains
with no gradient accumulation (``train.py:696-699``); MMBT and ViLT
accumulate (:class:`GradAccumulator`), and MMBT freezes subtrees by epoch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from multimodal_uncertainty_tpu_torch.data.loaders import map_batch
from multimodal_uncertainty_tpu_torch.ops.diversity import apply_diversity
from multimodal_uncertainty_tpu_torch.utils.seeding import side_generator


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """Uniform adapter between a model family and the trainer.

    model: the ``nn.Module``; called as ``model(x)`` unless ``apply_fn`` is set
    loss_fn(logits, y, eval) -> scalar
    data_forming(generator, x, y, phase) -> (x, y)  (None = identity)
    metric_fns: (name, fn(logits, y, eval)) pairs, computed on the device
    apply_fn(model, x, *, train, generator) -> logits  (None = ``model(x)``);
        ``generator`` is the step's, for the model's randomness
    frozen_fn(flags) -> the module prefixes frozen under the epoch's freeze
        flags (None = nothing freezes)
    diversity_kind, diversity_coef: the ensemble-diversity term added to the
        training loss of (B, E, C) logits (``ops/diversity.py``; ``none`` adds
        nothing)
    """

    model: nn.Module
    loss_fn: Callable
    data_forming: Optional[Callable] = None
    metric_fns: Sequence = ()
    apply_fn: Optional[Callable] = None
    frozen_fn: Optional[Callable] = None
    diversity_kind: str = "none"
    diversity_coef: float = 0.0


class GradAccumulator:
    """True gradient accumulation (the JAX package's ``steps.py:103-141``):
    each micro-batch's gradient is divided by ``every`` and added to a sum,
    which the optimizer applies, and which is then cleared, when the count of
    micro-steps reaches a multiple of ``every``. The count runs across epochs,
    so a window can straddle two, as in the JAX package. A frozen parameter
    adds nothing (its gradient is not computed)."""

    def __init__(self, every: int, params: Iterable[Tuple[str, nn.Parameter]]):
        if every < 1:
            raise ValueError(f"gradient accumulation steps must be >= 1, got {every}")
        self.every = every
        self.step = 0
        self.grads: Dict[str, torch.Tensor] = {
            n: torch.zeros_like(p, memory_format=torch.contiguous_format) for n, p in params}

    @torch.no_grad()
    def add(self, named_params: Iterable[Tuple[str, nn.Parameter]]) -> bool:
        """Add the parameters' gradients / every; count the micro-step.
        Returns True when the sum is due to be applied."""
        grads = {n: p.grad for n, p in named_params if p.grad is not None}
        if grads:
            scaled = torch._foreach_div(list(grads.values()), float(self.every))
            torch._foreach_add_([self.grads[n] for n in grads], scaled)
        self.step += 1
        return self.step % self.every == 0

    @torch.no_grad()
    def clear(self) -> None:
        torch._foreach_zero_(list(self.grads.values()))

    def load_state_dict(self, step: int, grads: dict) -> None:
        if set(grads) != set(self.grads):
            raise ValueError(f"accumulated gradients: missing {sorted(set(self.grads) - set(grads))}, "
                             f"unexpected {sorted(set(grads) - set(self.grads))}")
        for n, t in grads.items():
            self.grads[n].copy_(t)
        self.step = int(step)


def to_device(batch, device) -> Tuple:
    """A loader's numpy ``(x, y)`` batch, ``x`` a tuple of arrays (or, for
    ViLT, a dict of them; for FashionMNIST one array) -> tensors on
    ``device``."""
    return map_batch(batch, lambda a: torch.as_tensor(np.asarray(a)).to(device,
                                                                         non_blocking=True))


def _forward(bundle: ModelBundle, x, *, train: bool, generator=None):
    if bundle.apply_fn is None:
        return bundle.model(x)
    return bundle.apply_fn(bundle.model, x, train=train, generator=generator)


# the step generator's stream for the diversity noise (the JAX step's k_div)
DIVERSITY_STREAM = 3


def _train_loss(bundle: ModelBundle, logits, y, generator) -> torch.Tensor:
    """The loss, with the diversity term where the bundle asks for one and
    the logits have a head axis. ``random`` draws its noise from a generator
    of its own, so the permutations and dropout seeds that ``generator``
    gives are the same with diversity on or off."""
    loss = bundle.loss_fn(logits, y, eval=False)
    if bundle.diversity_kind != "none" and logits.ndim == 3:
        loss = apply_diversity(loss, logits, y, side_generator(generator, DIVERSITY_STREAM),
                               kind=bundle.diversity_kind, coef=bundle.diversity_coef)
    return loss


def _is_frozen(name: str, frozen: Sequence[str]) -> bool:
    return any(name.startswith(prefix + ".") for prefix in frozen)


def train_step(bundle: ModelBundle, optimizer, x, y,
               generator: Optional[torch.Generator] = None, *,
               flags: Optional[Sequence[bool]] = None,
               accumulator: Optional[GradAccumulator] = None) -> dict:
    """One micro-step; returns the loss and metrics as device scalars.

    Without ``accumulator`` the optimizer (``update()`` from the parameters'
    gradients) steps every call. With one, the gradient joins its sum, and
    the optimizer (``update(grads)``, with ``active`` when something is
    frozen) applies the sum every ``accumulator.every`` calls; the reported loss is then loss / every, as
    the JAX package reports it. Parameters under the prefixes that
    ``bundle.frozen_fn(flags)`` names take no gradient (``requires_grad``
    off, so their backward is skipped) and no update, weight decay
    included."""
    model = bundle.model
    model.train()
    if bundle.data_forming is not None:
        x, y = bundle.data_forming(generator, x, y, "train")
    if accumulator is None:
        logits = _forward(bundle, x, train=True, generator=generator)
        loss = _train_loss(bundle, logits, y, generator)
        optimizer.zero_grad()
        loss.backward()
        optimizer.update()
        reported = loss.detach()
    else:
        frozen = bundle.frozen_fn(flags) if bundle.frozen_fn and flags is not None else ()
        named = list(model.named_parameters())
        for name, p in named:
            p.requires_grad_(not _is_frozen(name, frozen))
        logits = _forward(bundle, x, train=True, generator=generator)
        loss = _train_loss(bundle, logits, y, generator)
        loss.backward()
        if accumulator.add(named):
            if frozen:  # only BertAdam (MMBT) takes a freeze mask
                optimizer.update(accumulator.grads,
                                 active=[n for n, _ in named if not _is_frozen(n, frozen)])
            else:
                optimizer.update(accumulator.grads)
            accumulator.clear()
        for _, p in named:  # the sum holds them now; free them for the next step
            p.grad = None
        reported = loss.detach() / accumulator.every
    logits = logits.detach()
    metrics = {name: fn(logits, y, eval=False) for name, fn in bundle.metric_fns}
    return {"loss": reported, **metrics}


@torch.inference_mode()
def eval_step(bundle: ModelBundle, x, y):
    """(logs, preds, y): loss and metrics on the head-mean predictions
    (the logits themselves for a model without an ensemble axis)."""
    bundle.model.eval()
    if bundle.data_forming is not None:
        x, y = bundle.data_forming(None, x, y, "eval")
    logits = _forward(bundle, x, train=False)
    loss = bundle.loss_fn(logits, y, eval=True)
    metrics = {name: fn(logits, y, eval=True) for name, fn in bundle.metric_fns}
    preds = logits.mean(dim=1) if logits.ndim == 3 else logits
    return {"loss": loss, **metrics}, preds, y
