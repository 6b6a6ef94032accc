"""Checkpoint I/O (port of ``training/checkpoint.py``).

Same artifact contract as the JAX package and its reference: files named
``model_best_val.pt``, ``model_epoch_{e}.pt``, ``model_last_epoch.pt``
holding ``{'model': ..., 'optimizer': ...}``, here as torch files of a state
dict, read back with ``weights_only=True``. For training, ``'optimizer'``
holds the JAX package's layout: ``{'opt_state': {'step', 'mu', 'nu',
'lr_scale'}, 'step': ...}``; the learning-rate schedule is a function of the
step and ``lr_scale``, so this is the scheduler's state as well.
"""
from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import torch
from torch import nn


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def save_weights(model: nn.Module | dict, opt_state: Optional[dict], filename: str) -> None:
    """Write ``{'model': state_dict, 'optimizer': opt_state or {}}`` atomically,
    every tensor copied to the host."""
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    state = {
        "model": _to_cpu(dict(sd)),
        "optimizer": _to_cpu(opt_state) if opt_state is not None else {},
    }
    tmp = filename + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, filename)


def load_weights(filename: str) -> Tuple[dict, Any]:
    """Returns (model_state_dict, opt_state), tensors on the CPU."""
    state = torch.load(filename, map_location="cpu", weights_only=True)
    return state["model"], state.get("optimizer", {})


def restore_into(model: nn.Module, loaded: dict) -> nn.Module:
    """Load ``loaded`` into ``model`` strictly: the same keys and shapes, cast
    to the model's dtypes. Raises ValueError on any mismatch."""
    own = model.state_dict()
    missing = sorted(set(own) - set(loaded))
    extra = sorted(set(loaded) - set(own))
    if missing or extra:
        raise ValueError(f"checkpoint keys differ: missing {missing}, unexpected {extra}")
    for k, t in own.items():
        if tuple(loaded[k].shape) != tuple(t.shape):
            raise ValueError(
                f"shape mismatch at {k}: checkpoint {tuple(loaded[k].shape)} "
                f"vs model {tuple(t.shape)}"
            )
    model.load_state_dict({k: loaded[k].to(own[k].dtype) for k in own}, strict=True)
    return model
