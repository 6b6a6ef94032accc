"""MIMO ResNet for the FashionMNIST four-view setup (port of
``models/mimo_resnet.py``).

The reference's truncated ResNet and MIMO wrapper (``src/model.py:17-112``):
conv1 (64) -> BatchNorm -> ReLU -> layer1 (2 BasicBlocks of 64) -> layer2 (2
of 128, stride 2) -> ``AvgPool2d(4)`` (floor: 7x7 -> 1x1) -> the fused
multi-head FC. A 5-D batch (B, E, C, H, W) folds the ensemble into the input
channels (E * C), so all members share one convolution; weight-sharing feeds
4-D (B * 4, 1, 14, 14) batches. NCHW throughout (the JAX package is NHWC
inside); the convolutions run on ``F.conv2d``, as in MMBT's ResNet.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_uncertainty_tpu_torch.models.layers import (
    BasicBlock,
    BatchNorm2d,
    Conv2d,
    MultiHeadFC,
)
from multimodal_uncertainty_tpu_torch.ops.losses import mimo_cross_entropy


class ResNetTrunk(nn.Module):
    """The two-stage truncated ResNet (reference ``src/model.py:17-56``):
    (B, C_in, H, W) -> (B, 128) features (at 14x14 input)."""

    def __init__(self, in_channels: int, layers: Sequence[int] = (2, 2), *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = Conv2d(in_channels, 64, 3, generator=generator)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for stage, ((planes, stride), blocks) in enumerate(zip(((64, 1), (128, 2)), layers)):
            stack = []
            for j in range(blocks):
                s = stride if j == 0 else 1
                downsample = j == 0 and (s != 1 or inplanes != planes)
                stack.append(BasicBlock(inplanes, planes, s, downsample, generator=generator))
                inplanes = planes
            self.add_module(f"layer{stage + 1}", nn.Sequential(*stack))
        self.n_stages = len(layers)
        self.out_features = inplanes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return F.avg_pool2d(x, 4).flatten(1)  # torch AvgPool2d(4): kernel 4, stride 4, floor


class MIMOResNet(nn.Module):
    """MIMO image classifier (reference ``src/model.py:72-112``): (B, E, C,
    H, W) or (B, C, H, W) -> logits (B, out_dim, num_classes). ``emb_dim``
    x ``num_channels`` is the trunk's input channels."""

    def __init__(self, num_channels: int = 1, emb_dim: int = 4, out_dim: int = 1,
                 num_classes: int = 10, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.trunk = ResNetTrunk(emb_dim * num_channels, generator=generator)
        self.output_layer = MultiHeadFC(self.trunk.out_features, num_classes, out_dim,
                                        generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 5:  # fold the ensemble into the channels
            b, e, c, h, w = x.shape
            x = x.reshape(b, e * c, h, w)
        dtype = self.trunk.conv1.weight.dtype
        return self.output_layer(self.trunk(x.to(dtype)))

    @staticmethod
    def compute_loss(y_hat, y, *, eval: bool = False):
        return mimo_cross_entropy(y_hat, y, eval=eval)
