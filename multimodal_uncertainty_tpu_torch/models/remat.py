"""Rematerialised blocks (the JAX package's ``nn.remat``, ``train --remat``).

:func:`remat` runs a block under ``torch.utils.checkpoint`` (non-reentrant, so
a block whose inputs need no gradient, MMBT's frozen encoders, still passes
gradients on to what follows it): the forward keeps only the block's inputs,
and the backward runs the block's forward again to rebuild what it needs. The
second forward must compute what the first did:

- torch's default CPU and CUDA generators (``nn.Dropout``) are put back by
  the checkpoint itself;
- an explicit generator the block draws from (BERT's attention-probability
  keep mask, ``models/bert.py``) is not: :func:`remat` takes its state before
  the forward and sets it again for the recompute, then restores the state the
  generator had;
- the recompute is marked (:func:`recomputing`), so a BatchNorm in training
  mode updates its running statistics once, in the first forward, as flax
  drops the recompute's ``batch_stats`` mutation.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

_local = threading.local()


def recomputing() -> bool:
    """True while a rematerialised block is being recomputed on this thread."""
    return getattr(_local, "depth", 0) > 0


class _Recompute:
    """The recompute's context: marks it, and runs it from ``state``, the
    explicit generator's state at the first forward."""

    def __init__(self, generator: Optional[torch.Generator], state):
        self.generator, self.state, self.held = generator, state, None

    def __enter__(self):
        _local.depth = getattr(_local, "depth", 0) + 1
        if self.generator is not None:
            self.held = self.generator.get_state()
            self.generator.set_state(self.state)

    def __exit__(self, *exc):
        _local.depth -= 1
        if self.generator is not None:
            self.generator.set_state(self.held)


def remat(fn: Callable, *args, generator: Optional[torch.Generator] = None):
    """``fn(*args)`` with its activations recomputed in the backward instead
    of kept; ``generator`` is an explicit generator ``fn`` draws from."""
    state = None if generator is None else generator.get_state()
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _Recompute(generator, state)))


def use_remat(on: bool) -> bool:
    """Whether a block built with ``remat=on`` rematerialises now: only while
    autograd records (training); eval and serving run it plainly."""
    return on and torch.is_grad_enabled()
