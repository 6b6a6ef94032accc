"""Optimizers and schedules (port of ``training/optim.py``): AdamW with the HF
cosine-warmup schedule (``cosine_warmup_schedule`` :68-78, ``adamw``
:158-199) for the fusion models, and with a constant rate
(``constant_schedule`` :51-52) for ViLT; BertAdam with the warmup-linear schedule
(``warmup_linear_schedule`` :55-65, ``bert_adam`` :207-292) for MMBT and the
MIMO transformer; SGD with momentum (``sgd`` :121-150) at a constant rate for
the MIMO ResNet; ``ReduceLROnPlateau`` (:300-362) for all but the fusion models.

Written by hand rather than as ``torch.optim`` classes so that the state is
the JAX package's, leaf for leaf (``step``, ``mu``, ``nu``, ``lr_scale``),
keyed by parameter name. AdamW's semantics kept from the JAX package:

- the learning rate of step t is ``schedule(t) * lr_scale`` taken before the
  step counter is incremented, so step 0 runs at lr 0 under the warmup;
- bias-corrected moments, ``eps`` added to sqrt(v_hat);
- decoupled weight decay on **every** parameter, biases and LayerNorms
  included (the fusion setup passes no decay mask);
- the schedule and the bias corrections are computed in float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch


def cosine_warmup_schedule(lr: float, warmup_steps: int, total_steps: int) -> Callable[[int], float]:
    """HF ``get_cosine_schedule_with_warmup`` (num_cycles=0.5), in float32."""
    f32 = np.float32

    def fn(step: int) -> float:
        s = f32(step)
        if s < warmup_steps:
            return float(f32(lr) * (s / f32(max(1.0, warmup_steps))))
        progress = (s - f32(warmup_steps)) / f32(max(1.0, total_steps - warmup_steps))
        decay = max(f32(0.0), f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * progress)))
        return float(f32(lr) * f32(decay))

    return fn


def constant_schedule(lr: float) -> Callable[[int], float]:
    """The learning rate ``lr`` at every step, in float32 (ViLT's AdamW)."""
    value = float(np.float32(lr))
    return lambda step: value


def warmup_linear_schedule(lr: float, warmup: float, t_total: float) -> Callable[[int], float]:
    """BertAdam's ``warmup_linear``, in float32: lr * x / warmup below
    ``warmup``, else lr * (1 - x), with x = step / t_total. It goes negative
    past ``t_total``, a BertAdam quirk the JAX package keeps."""
    f32 = np.float32

    def fn(step: int) -> float:
        x = f32(step) / f32(t_total)
        w = x / f32(max(warmup, 1e-12)) if x < f32(warmup) else f32(1.0) - x
        return float(f32(lr) * f32(w))

    return fn


def _grad_list(params: Dict[str, torch.nn.Parameter], names, grads) -> list:
    """``grads[n]`` for each of ``names``, or when ``grads`` is None the
    parameters' ``.grad`` (a parameter with none counts as a zero gradient,
    as in the JAX tree update)."""
    if grads is not None:
        return [grads[n] for n in names]
    return [params[n].grad if params[n].grad is not None else torch.zeros_like(params[n])
            for n in names]


class AdamW:
    """AdamW over named parameters; ``update()`` applies one step from their
    ``.grad``. The state lives on the parameters' device."""

    def __init__(
        self,
        params: Iterable[Tuple[str, torch.nn.Parameter]],
        schedule: Callable[[int], float],
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
    ):
        self.params: Dict[str, torch.nn.Parameter] = dict(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.step = 0
        self.lr_scale = 1.0
        self.mu = {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for n, p in self.params.items()}

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def update(self, grads: Optional[Mapping[str, torch.Tensor]] = None) -> None:
        """One AdamW step from ``grads`` (a gradient for every parameter, the
        accumulated sum under gradient accumulation) or, when None, from the
        parameters' ``.grad`` (a parameter with no gradient counts as a zero
        gradient, as in the JAX tree update)."""
        names = list(self.params)
        params = [self.params[n] for n in names]
        grads = _grad_list(self.params, names, grads)
        mu = [self.mu[n] for n in names]
        nu = [self.nu[n] for n in names]
        step = self.step + 1
        lr = float(np.float32(self.schedule(self.step)) * np.float32(self.lr_scale))
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(step))
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(step))
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)
        self.step = step

    def state_dict(self) -> dict:
        """The JAX ``adamw`` state layout: step, mu, nu, lr_scale."""
        return {
            "step": torch.tensor(self.step, dtype=torch.int64),
            "mu": dict(self.mu),
            "nu": dict(self.nu),
            "lr_scale": torch.tensor(self.lr_scale, dtype=torch.float32),
        }

    def load_state_dict(self, state: dict) -> None:
        """Strict restore: the same parameter names and shapes, copied onto
        the parameters' device."""
        for key in ("mu", "nu"):
            loaded = state[key]
            if set(loaded) != set(self.params):
                missing = sorted(set(self.params) - set(loaded))
                extra = sorted(set(loaded) - set(self.params))
                raise ValueError(f"optimizer {key}: missing {missing}, unexpected {extra}")
            own = getattr(self, key)
            for n, t in loaded.items():
                if tuple(t.shape) != tuple(own[n].shape):
                    raise ValueError(f"optimizer {key}[{n}]: shape {tuple(t.shape)} "
                                     f"vs {tuple(own[n].shape)}")
                own[n].copy_(t)
        self.step = int(state["step"])
        self.lr_scale = float(state["lr_scale"])


class SGD:
    """torch-style SGD over named parameters, as the JAX package's ``sgd``:
    the weight decay is coupled (``g + weight_decay * p``, on every
    parameter, BatchNorm's included), the momentum buffer has no dampening
    (``buf = momentum * buf + g``), and the step is ``-lr * buf`` with ``lr
    = schedule(step) * lr_scale`` in float32, ``lr_scale`` set by the plateau
    scheduler. ``update()`` applies one step from the parameters' ``.grad``."""

    def __init__(
        self,
        params: Iterable[Tuple[str, torch.nn.Parameter]],
        schedule: Callable[[int], float],
        momentum: float = 0.9,
        weight_decay: float = 0.0,
    ):
        self.params: Dict[str, torch.nn.Parameter] = dict(params)
        self.schedule = schedule
        self.momentum, self.weight_decay = momentum, weight_decay
        self.step = 0
        self.lr_scale = 1.0
        self.buf = {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                    for n, p in self.params.items()}

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def update(self, grads: Optional[Mapping[str, torch.Tensor]] = None) -> None:
        """One step from ``grads`` or, when None, from the parameters' ``.grad``."""
        names = list(self.params)
        params = [self.params[n] for n in names]
        grads = _grad_list(self.params, names, grads)
        lr = float(np.float32(self.schedule(self.step)) * np.float32(self.lr_scale))
        bufs = [self.buf[n] for n in names]
        if self.weight_decay:
            grads = torch._foreach_add(grads, params, alpha=self.weight_decay)
        torch._foreach_mul_(bufs, self.momentum)
        torch._foreach_add_(bufs, grads)
        torch._foreach_add_(params, bufs, alpha=-lr)
        self.step += 1

    def state_dict(self) -> dict:
        """The JAX ``sgd`` state layout: step, momentum, lr_scale."""
        return {
            "step": torch.tensor(self.step, dtype=torch.int64),
            "momentum": dict(self.buf),
            "lr_scale": torch.tensor(self.lr_scale, dtype=torch.float32),
        }

    def load_state_dict(self, state: dict) -> None:
        """Strict restore: the same parameter names and shapes."""
        loaded = state["momentum"]
        if set(loaded) != set(self.params):
            raise ValueError(f"optimizer momentum: missing {sorted(set(self.params) - set(loaded))}"
                             f", unexpected {sorted(set(loaded) - set(self.params))}")
        for n, t in loaded.items():
            if tuple(t.shape) != tuple(self.buf[n].shape):
                raise ValueError(f"optimizer momentum[{n}]: shape {tuple(t.shape)} "
                                 f"vs {tuple(self.buf[n].shape)}")
            self.buf[n].copy_(t)
        self.step = int(state["step"])
        self.lr_scale = float(state["lr_scale"])


# the reference's torch name groups without weight decay (``train.py:137-141``)
NO_DECAY = ("bias", "LayerNorm.bias", "LayerNorm.weight")


class BertAdam:
    """``pytorch_pretrained_bert``'s BertAdam over named parameters, as the
    JAX package's ``bert_adam``:

    - each parameter's gradient is clipped to norm ``max_grad_norm`` on its
      own (not globally);
    - no bias correction; ``eps`` is added to sqrt(v);
    - weight decay is added into the update (not decoupled), except for the
      ``NO_DECAY`` names;
    - every parameter keeps its own step, and its learning rate is
      ``warmup_linear(step) * lr_scale``, the step taken before it advances.
      A parameter left out of ``active`` (frozen) takes no update, no moment
      update and no step, so its schedule lags the live ones once unfrozen;
    - ``lr_scale`` is set by the plateau scheduler.
    """

    def __init__(
        self,
        params: Iterable[Tuple[str, torch.nn.Parameter]],
        lr: float,
        warmup: float,
        t_total: float,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-6,
        weight_decay: float = 0.01,
        max_grad_norm: float = 1.0,
    ):
        self.params: Dict[str, torch.nn.Parameter] = dict(params)
        self.schedule = warmup_linear_schedule(lr, warmup, t_total)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm
        self.lr_scale = 1.0
        self.steps = {n: 0 for n in self.params}
        self.decay = {n: not any(nd in n for nd in NO_DECAY) for n in self.params}
        self.mu = {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for n, p in self.params.items()}

    def lr(self, name: str) -> float:
        """The learning rate parameter ``name`` takes at its next update."""
        return float(np.float32(self.schedule(self.steps[name])) * np.float32(self.lr_scale))

    @property
    def step(self) -> int:
        """Updates taken: the most steps of any parameter (all of them where
        nothing freezes, as in the MIMO transformer's training)."""
        return max(self.steps.values(), default=0)

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def update(self, grads: Optional[Mapping[str, torch.Tensor]] = None,
               active: Optional[Iterable[str]] = None) -> None:
        """One step of the ``active`` parameters (all when None) from
        ``grads``, a gradient for every parameter, or when None from the
        parameters' ``.grad`` (a parameter with none counts as a zero
        gradient)."""
        live = set(self.params if active is None else active)
        names = [n for n in self.params if n in live]
        params = [self.params[n] for n in names]
        gs = _grad_list(self.params, names, grads)
        if self.max_grad_norm > 0:
            norms = torch.stack(torch._foreach_norm(gs)).float()
            coef = torch.clamp(self.max_grad_norm / torch.clamp(norms, min=1e-12), max=1.0)
            gs = torch._foreach_mul(gs, list(torch.unbind(coef)))
        mu = [self.mu[n] for n in names]
        nu = [self.nu[n] for n in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, gs, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, gs, gs, value=1.0 - self.b2)
        upd = torch._foreach_sqrt(nu)
        torch._foreach_add_(upd, self.eps)
        upd = torch._foreach_div(mu, upd)
        decayed = [i for i, n in enumerate(names) if self.decay[n]]
        if self.weight_decay > 0 and decayed:
            torch._foreach_add_([upd[i] for i in decayed], [params[i] for i in decayed],
                                alpha=self.weight_decay)
        torch._foreach_mul_(upd, [-self.lr(n) for n in names])
        torch._foreach_add_(params, upd)
        for n in names:
            self.steps[n] += 1

    def state_dict(self) -> dict:
        """The JAX ``bert_adam`` state layout: per-parameter step, mu, nu,
        lr_scale."""
        return {
            "step": {n: torch.tensor(t, dtype=torch.int64) for n, t in self.steps.items()},
            "mu": dict(self.mu),
            "nu": dict(self.nu),
            "lr_scale": torch.tensor(self.lr_scale, dtype=torch.float32),
        }

    def load_state_dict(self, state: dict) -> None:
        """Strict restore: the same parameter names and shapes."""
        for key in ("step", "mu", "nu"):
            loaded = state[key]
            if set(loaded) != set(self.params):
                missing = sorted(set(self.params) - set(loaded))
                extra = sorted(set(loaded) - set(self.params))
                raise ValueError(f"optimizer {key}: missing {missing}, unexpected {extra}")
        for key in ("mu", "nu"):
            own = getattr(self, key)
            for n, t in state[key].items():
                if tuple(t.shape) != tuple(own[n].shape):
                    raise ValueError(f"optimizer {key}[{n}]: shape {tuple(t.shape)} "
                                     f"vs {tuple(own[n].shape)}")
                own[n].copy_(t)
        self.steps = {n: int(t) for n, t in state["step"].items()}
        self.lr_scale = float(state["lr_scale"])


@dataclasses.dataclass
class ReduceLROnPlateau:
    """``torch.optim.lr_scheduler.ReduceLROnPlateau`` semantics on a scale:
    :meth:`step` takes the monitored value once an epoch and returns the
    scale to write into the optimizer's ``lr_scale``."""

    mode: str = "min"
    factor: float = 0.1
    patience: int = 10
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    cooldown: int = 0
    min_lr: float = 0.0
    base_lr: float = 1.0
    eps: float = 1e-8

    scale: float = 1.0
    best: float = None  # type: ignore[assignment]
    num_bad_epochs: int = 0
    cooldown_counter: int = 0

    def __post_init__(self):
        self.best = float("inf") if self.mode == "min" else float("-inf")

    def _is_better(self, a: float, best: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < best * (1.0 - self.threshold)
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1.0 + self.threshold)
        return a > best + self.threshold

    def step(self, metric: float) -> float:
        current = float(metric)
        if self._is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            old_lr = self.scale * self.base_lr
            new_lr = max(old_lr * self.factor, self.min_lr)
            if old_lr - new_lr > self.eps:
                self.scale = new_lr / self.base_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.scale

    def state_dict(self) -> dict:
        return {k: getattr(self, k) for k in ("scale", "best", "num_bad_epochs",
                                               "cooldown_counter")}

    def load_state_dict(self, sd: dict) -> None:
        for k, v in sd.items():
            setattr(self, k, type(getattr(self, k))(v))
