"""Carry a JAX-package checkpoint's weights into the port (fusion and MMBT).

``fusion_state_dict_from_jax`` takes the params tree that the JAX package's
``setup_flava`` builds, as nested dicts of numpy arrays (what its
``load_weights`` returns under ``"params"``), and returns a state dict for
:class:`~multimodal_uncertainty_tpu_torch.models.fusion.FlavaFusionTransformer`.

Layout changes: a ``Linear`` kernel is (in, out) in JAX and (out, in) in
torch, so it is transposed. ``EnsembleHeads`` (kernel (E, D, C), bias (E, C))
and ``class_embeddings`` (D, E) keep the JAX layout. ``resblocks_<i>`` becomes
``resblocks.<i>``. ``adamw_state_from_jax`` carries the AdamW state across
the same way, so a JAX run's weights and optimizer both continue in the port.
``mmbt_state_dict_from_jax`` does the same for ``MultimodalBertClf``, running
statistics included, and ``vilt_state_dict_from_jax`` for
``ViltForImagesAndTextClassification``; ``mimo_resnet_state_dict_from_jax``
and ``mimo_transformer_state_dict_from_jax`` for the FashionMNIST round's
``MIMOResNet`` and ``MIMOTransformer``.
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


# JAX MMBT module names -> the port's (HF BERT and torchvision names)
_MMBT_SCOPES = [
    (re.compile(r"^layer_(\d+)$"), r"layer.\1"),
    (re.compile(r"^layer(\d)_(\d+)$"), r"layer\1.\2"),
    (re.compile(r"^self$"), "attention.self"),
    (re.compile(r"^attn_output_(dense|LayerNorm)$"), r"attention.output.\1"),
    (re.compile(r"^(intermediate|output)_(dense|LayerNorm)$"), r"\1.\2"),
    (re.compile(r"^downsample_conv$"), "downsample.0"),
    (re.compile(r"^downsample_bn$"), "downsample.1"),
]
_MMBT_LEAVES = {
    "scale": "weight", "mean": "running_mean", "var": "running_var",
    "ln_weight": "LayerNorm.weight", "ln_bias": "LayerNorm.bias",
    "word_embeddings": "word_embeddings.weight",
    "position_embeddings": "position_embeddings.weight",
    "token_type_embeddings": "token_type_embeddings.weight",
}


def _mmbt_scope(name: str) -> str:
    for pattern, repl in _MMBT_SCOPES:
        if pattern.match(name):
            return pattern.sub(repl, name)
    return name


def mmbt_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's MMBT ``{"params", "batch_stats"}`` (numpy trees) ->
    the state dict of :class:`~multimodal_uncertainty_tpu_torch.models.mmbt.
    MultimodalBertClf`.

    Conv kernels go HWIO -> OIHW and ``Linear`` kernels (in, out) -> (out,
    in); BatchNorm ``scale`` / ``bias`` / ``mean`` / ``var`` become ``weight``
    / ``bias`` / ``running_mean`` / ``running_var`` (plus torch's
    ``num_batches_tracked``, 0); the five shared tables under
    ``enc/txt_embeddings`` become the text embedding module's."""
    state = {}
    trees = [variables["params"]] + ([variables["batch_stats"]] if "batch_stats" in variables
                                     else [])
    for tree in trees:
        for path, leaf in _flatten(tree):
            arr = np.array(leaf, dtype=np.float32)  # a copy: the tensor owns its memory
            *parents, name = path
            if parents and parents[-1] in ("conv", "bn"):  # flax wrapper scopes
                parents = parents[:-1]
            if name == "kernel":
                arr = arr.transpose(3, 2, 0, 1).copy() if arr.ndim == 4 else arr.T.copy()
                name = "weight"
            key = ".".join([*(_mmbt_scope(p) for p in parents), _MMBT_LEAVES.get(name, name)])
            state[key] = torch.from_numpy(arr)
            if key.endswith(".running_var"):
                state[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return state


def vilt_state_dict_from_jax(variables) -> dict[str, torch.Tensor]:
    """The JAX package's ViLT params (a numpy tree, or a variables dict holding
    ``"params"``) -> the state dict of :class:`~multimodal_uncertainty_tpu_torch.
    models.vilt.ViltForImagesAndTextClassification`.

    ``Linear`` kernels go (in, out) -> (out, in), the patch convolution's
    HWIO -> OIHW; ``block_<i>`` becomes ``block.<i>``; the embedding tables,
    ``image_cls`` and the LayerNorms keep their names and layout."""
    if "params" in variables and isinstance(variables["params"], Mapping):
        variables = variables["params"]
    state = {}
    for path, leaf in _flatten(variables):
        arr = np.array(leaf, dtype=np.float32)  # a copy: the tensor owns its memory
        *parents, name = path
        if name == "kernel":
            arr = arr.transpose(3, 2, 0, 1).copy() if arr.ndim == 4 else arr.T.copy()
            name = "weight"
        parents = [re.sub(r"^block_(\d+)$", r"block.\1", p) for p in parents]
        state[".".join([*parents, name])] = torch.from_numpy(arr)
    return state


# the JAX BasicBlock's auto-named submodules -> the port's (torchvision names)
_BLOCK = {"Conv_0": "conv1", "BatchNorm_0": "bn1", "Conv_1": "conv2", "BatchNorm_1": "bn2",
          "Conv_2": "downsample.0", "BatchNorm_2": "downsample.1"}
_BN_LEAVES = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def mimo_resnet_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's MIMO ResNet ``{"params", "batch_stats"}`` (numpy
    trees) -> the state dict of :class:`~multimodal_uncertainty_tpu_torch.
    models.mimo_resnet.MIMOResNet`.

    Conv kernels go HWIO -> OIHW and the output FC's (in, out) -> (out, in);
    BatchNorm ``scale`` / ``bias`` / ``mean`` / ``var`` become ``weight`` /
    ``bias`` / ``running_mean`` / ``running_var`` (plus torch's
    ``num_batches_tracked``, 0); ``layer<s>_<j>`` becomes ``layer<s>.<j>`` and
    its ``Conv_k`` / ``BatchNorm_k`` the block's ``conv1``, ``bn1``, ``conv2``,
    ``bn2`` and ``downsample.0`` / ``.1``."""
    state = {}
    trees = [variables["params"]] + ([variables["batch_stats"]] if "batch_stats" in variables
                                     else [])
    for tree in trees:
        for path, leaf in _flatten(tree):
            arr = np.array(leaf, dtype=np.float32)  # a copy: the tensor owns its memory
            *parents, name = path
            if parents and parents[-1] in ("conv", "bn"):  # flax wrapper scopes
                parents = parents[:-1]
            if name == "kernel":
                arr = arr.transpose(3, 2, 0, 1).copy() if arr.ndim == 4 else arr.T.copy()
                name = "weight"
            parents = [_BLOCK.get(p, re.sub(r"^layer(\d)_(\d+)$", r"layer\1.\2", p))
                       for p in parents]
            key = ".".join([*parents, _BN_LEAVES.get(name, name)])
            state[key] = torch.from_numpy(arr)
            if key.endswith(".running_var"):
                state[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return state


def mimo_transformer_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's MIMO transformer params (a numpy tree, or a
    variables dict holding ``"params"``) -> the state dict of
    :class:`~multimodal_uncertainty_tpu_torch.models.mimo_transformer.
    MIMOTransformer`: the fusion model's layout (``Linear`` kernels (in, out)
    -> (out, in), ``resblocks_<i>`` -> ``resblocks.<i>``, ``EnsembleHeads``'
    (E, D, C) kernel and (E, C) bias as they are)."""
    return fusion_state_dict_from_jax(params)
