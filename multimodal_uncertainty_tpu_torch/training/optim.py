"""AdamW with the HF cosine-warmup schedule (port of ``training/optim.py``
``cosine_warmup_schedule`` :68-78 and ``adamw`` :158-199).

Written by hand rather than as ``torch.optim.AdamW`` + ``LambdaLR`` so that
its state is the JAX package's, leaf for leaf: ``step``, ``mu``, ``nu`` and
``lr_scale``, keyed by parameter name. Semantics kept from the JAX package:

- the learning rate of step t is ``schedule(t) * lr_scale`` taken before the
  step counter is incremented, so step 0 runs at lr 0 under the warmup;
- bias-corrected moments, ``eps`` added to sqrt(v_hat);
- decoupled weight decay on **every** parameter, biases and LayerNorms
  included (the fusion setup passes no decay mask);
- the schedule and the bias corrections are computed in float32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Tuple

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
    def update(self) -> None:
        """One AdamW step from the parameters' gradients (a parameter with no
        gradient counts as a zero gradient, as in the JAX tree update)."""
        names = list(self.params)
        params = [self.params[n] for n in names]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
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
