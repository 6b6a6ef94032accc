"""Model setup (port of ``zoo.py::setup_flava``, :175-259, and of the model
part of ``setup_mmbt``, :313-379).

``build_flava`` builds the fusion model for serving; ``setup_flava`` builds
it for training with its bundle, its AdamW optimizer and the cosine-warmup
schedule. ``build_mmbt`` builds MMBT (BERT + ResNet) for serving.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional, Sequence

import torch

from multimodal_uncertainty_tpu_torch.device import resolve_device
from multimodal_uncertainty_tpu_torch.models.bert import BertConfig
from multimodal_uncertainty_tpu_torch.models.fusion import FlavaFusionTransformer
from multimodal_uncertainty_tpu_torch.models.mmbt import MultimodalBertClf
from multimodal_uncertainty_tpu_torch.ops.data_forming import data_forming_func_transformer
from multimodal_uncertainty_tpu_torch.ops.losses import mimo_cross_entropy
from multimodal_uncertainty_tpu_torch.ops.metrics import accuracy
from multimodal_uncertainty_tpu_torch.training.optim import AdamW, cosine_warmup_schedule
from multimodal_uncertainty_tpu_torch.training.steps import ModelBundle

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


def build_mmbt(
    n_classes: int = 101,
    *,
    bert_config: Optional[BertConfig] = None,
    resnet_layers: Sequence[int] = (3, 8, 36, 3),
    num_image_embeds: int = 3,
    vocab_size: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> MultimodalBertClf:
    """MMBT, by default BERT-base + ResNet-152 with 3 image embeddings, fp32,
    in eval mode on ``device`` (default ``cuda``). ``vocab_size`` overrides
    the BERT config's. Weights are drawn on the CPU from ``generator``, then
    moved; it is also the template a checkpoint is restored into."""
    dev = resolve_device(device)
    cfg = bert_config or BertConfig.base()
    if vocab_size is not None and vocab_size != cfg.vocab_size:
        cfg = dataclasses.replace(cfg, vocab_size=vocab_size)
    model = MultimodalBertClf(cfg, n_classes, num_image_embeds,
                              resnet_layers=tuple(resnet_layers), generator=generator)
    return model.to(dev).eval()


@dataclasses.dataclass
class Setup:
    model: FlavaFusionTransformer
    bundle: ModelBundle
    optimizer: AdamW
    schedule: Callable[[int], float]  # stepped every batch

    @property
    def step(self) -> int:
        """Optimizer steps taken (the schedule's position)."""
        return self.optimizer.step


def setup_flava(
    *,
    model_type: str = "Vanilla",
    n_classes: int = 2,
    lr: float = 1e-4,
    wd: float = 0.001,
    n_epochs: int = 100,
    steps_per_epoch: int = 100,
    multimodal_num_attention_heads: int = 3,
    multimodal_num_hidden_layers: int = 3,
    dropout: float = 0.0,
    clstoken: bool = False,
    avg_pool: bool = False,
    image_hidden_size: int = 768,
    text_hidden_size: int = 768,
    seed: int = 0,
    device=None,
) -> Setup:
    """The fusion model (fp32, weights drawn from ``seed`` on the CPU, then
    moved to ``device``, default ``cuda``), with AdamW (betas (0.9, 0.98),
    eps 1e-9, decay ``wd`` on every parameter) under the HF cosine schedule
    with 3 epochs of warmup, stepped every batch (``train.py:196-208``)."""
    if model_type not in MODEL_TYPES:
        raise ValueError(f"model_type {model_type!r} not in {MODEL_TYPES}")
    dev = resolve_device(device)
    model = FlavaFusionTransformer(
        out_dim=1 if model_type == "Vanilla" else 2,
        num_classes=n_classes,
        image_hidden_size=image_hidden_size,
        text_hidden_size=text_hidden_size,
        multimodal_num_attention_heads=multimodal_num_attention_heads,
        multimodal_num_hidden_layers=multimodal_num_hidden_layers,
        drop=dropout,
        avg_pool=avg_pool,
        cls_token=clstoken,
        generator=torch.Generator().manual_seed(seed),
    ).to(dev)
    schedule = cosine_warmup_schedule(lr, warmup_steps=steps_per_epoch * 3,
                                      total_steps=steps_per_epoch * n_epochs)
    optimizer = AdamW(model.named_parameters(), schedule, b1=0.9, b2=0.98, eps=1e-9,
                      weight_decay=wd)
    bundle = ModelBundle(
        model=model,
        loss_fn=mimo_cross_entropy,
        data_forming=lambda gen, x, y, phase: data_forming_func_transformer(
            x, y, phase=phase, model_type=model_type, generator=gen),
        metric_fns=(("acc", partial(accuracy, dummy_dim=True)),),
    )
    return Setup(model, bundle, optimizer, schedule)
