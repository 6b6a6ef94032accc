"""Carry a JAX-package fusion checkpoint's weights into the port.

``fusion_state_dict_from_jax`` takes the params tree that the JAX package's
``setup_flava`` builds, as nested dicts of numpy arrays (what its
``load_weights`` returns under ``"params"``), and returns a state dict for
:class:`~multimodal_uncertainty_tpu_torch.models.fusion.FlavaFusionTransformer`.

Layout changes: a ``Linear`` kernel is (in, out) in JAX and (out, in) in
torch, so it is transposed. ``EnsembleHeads`` (kernel (E, D, C), bias (E, C))
and ``class_embeddings`` (D, E) keep the JAX layout. ``resblocks_<i>`` becomes
``resblocks.<i>``. ``adamw_state_from_jax`` carries the AdamW state across
the same way, so a JAX run's weights and optimizer both continue in the port.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def fusion_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX fusion params (or a variables dict holding ``"params"``) -> torch state dict."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    state = {}
    for path, leaf in _flatten(params):
        arr = np.array(leaf, dtype=np.float32)  # a copy: the tensor owns its memory
        *parents, name = path
        if name == "kernel" and (not parents or parents[-1] != "output_layers"):
            arr = arr.T.copy()
            name = "weight"
        parents = [re.sub(r"^resblocks_(\d+)$", r"resblocks.\1", p) for p in parents]
        state[".".join([*parents, name])] = torch.from_numpy(arr)
    return state


def adamw_state_from_jax(opt_state: Mapping) -> dict:
    """The JAX package's ``adamw`` state (``step``, ``mu``, ``nu``,
    ``lr_scale``, as numpy trees; a JAX checkpoint holds it under
    ``optimizer/opt_state``) -> the state dict of the port's
    :class:`~multimodal_uncertainty_tpu_torch.training.optim.AdamW`. The
    moments take the same key mapping and transposes as the weights."""
    return {
        "step": torch.tensor(int(np.asarray(opt_state["step"])), dtype=torch.int64),
        "mu": fusion_state_dict_from_jax(opt_state["mu"]),
        "nu": fusion_state_dict_from_jax(opt_state["nu"]),
        "lr_scale": torch.tensor(float(np.asarray(opt_state["lr_scale"])), dtype=torch.float32),
    }
