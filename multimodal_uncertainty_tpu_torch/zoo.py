"""Model setup (port of the model part of ``zoo.py::setup_flava``).

The optimizer, schedule and train state come with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from multimodal_uncertainty_tpu_torch.device import resolve_device
from multimodal_uncertainty_tpu_torch.models.fusion import FlavaFusionTransformer

MODEL_TYPES = ("Vanilla", "MIMO-shuffle-instance", "MultiHead")


def build_flava(
    model_type: str = "Vanilla",
    n_classes: int = 2,
    heads: int = 3,
    layers: int = 3,
    clstoken: bool = False,
    avg_pool: bool = False,
    *,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> FlavaFusionTransformer:
    """The fusion model at the JAX package's widths (768-wide FLAVA embeddings
    and fusion width), fp32, in eval mode on ``device`` (default ``cuda``).
    ``out_dim`` is 1 for Vanilla and 2 (the ensemble heads) otherwise. Weights
    are drawn on the CPU from ``generator``, then moved."""
    if model_type not in MODEL_TYPES:
        raise ValueError(f"model_type {model_type!r} not in {MODEL_TYPES}")
    dev = resolve_device(device)
    model = FlavaFusionTransformer(
        out_dim=1 if model_type == "Vanilla" else 2,
        num_classes=n_classes,
        multimodal_num_attention_heads=heads,
        multimodal_num_hidden_layers=layers,
        avg_pool=avg_pool,
        cls_token=clstoken,
        generator=generator,
    )
    return model.to(dev).eval()
