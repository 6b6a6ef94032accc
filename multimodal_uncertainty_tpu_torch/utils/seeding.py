"""Seeding (port of ``utils/seeding.py``): host RNGs are seeded globally;
the model's weights and the MIMO permutations come from explicit
``torch.Generator``s derived from the run's seed."""
from __future__ import annotations

import random
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch


def set_seed(seed: int) -> int:
    """Seed Python's, numpy's and torch's global generators; returns ``seed``
    (the root of the run's explicit generators)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def derived_generator(seed: int, *path: int) -> torch.Generator:
    """A CPU generator seeded from ``(seed, *path)``: a pure function of its
    arguments, as ``jax.random.fold_in`` is for keys."""
    state = np.random.SeedSequence([seed, *path]).generate_state(2, np.uint64)
    return torch.Generator().manual_seed(int(state[0] >> np.uint64(1)))


def side_generator(generator: Optional[torch.Generator], stream: int) -> torch.Generator:
    """A CPU generator of its own for ``stream``, seeded from ``generator``'s
    initial seed without drawing from it (the JAX step's split of its key):
    what ``generator`` yields next is the same whether it is made or not."""
    return derived_generator(0 if generator is None else generator.initial_seed(), stream)


@contextmanager
def numpy_seed(seed, *addl_seeds):
    """Seed numpy's global generator inside the block and restore its state
    after (reference ``src/utils.py:167-181``; the drop-img draw uses it)."""
    if seed is None:
        yield
        return
    if len(addl_seeds) > 0:
        seed = int(hash((seed, *addl_seeds)) % 1e6)
    state = np.random.get_state()
    np.random.seed(seed)
    try:
        yield
    finally:
        np.random.set_state(state)
