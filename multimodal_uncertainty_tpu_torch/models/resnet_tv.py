"""torchvision-style ResNet, the MMBT image backbone (port of ``models/resnet_tv.py``).

The headless torchvision ResNet (``children()[:-2]``): conv 7x7/2 -> BatchNorm
-> ReLU -> max-pool 3x3/2 (padding 1) -> layer1..4 of Bottlenecks, ``(3, 8,
36, 3)`` for ResNet-152, the stride on the 3x3 conv -> (B, 2048, 7, 7) at
224x224; then the reference's adaptive pool to N image embeddings.

Parameter names are torchvision's (``conv1``, ``bn1``, ``layer{s}.{j}.conv1``,
``downsample.0`` / ``downsample.1``), so a torchvision ResNet-152 state dict
loads as it is. The trunk is NCHW like torchvision; :class:`ImageEncoder`
takes the JAX package's NHWC images and permutes them on the device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_uncertainty_tpu_torch.models.layers import BatchNorm2d, Conv2d
from multimodal_uncertainty_tpu_torch.models.remat import remat, use_remat

POOL_GRID = {1: (1, 1), 2: (2, 1), 3: (3, 1), 4: (2, 2), 5: (5, 1),
             6: (3, 2), 7: (7, 1), 8: (4, 2), 9: (3, 3)}


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        width = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, generator=generator)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, generator=generator)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, width, 1, generator=generator)
        self.bn3 = BatchNorm2d(width)
        self.downsample = (
            nn.Sequential(Conv2d(inplanes, width, 1, stride, generator=generator),
                          BatchNorm2d(width))
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNetTrunk(nn.Module):
    """Headless torchvision ResNet: (B, 3, H, W) -> (B, 2048, H/32, W/32).
    ``remat``: each bottleneck is rematerialised in training."""

    def __init__(self, layers: Sequence[int] = (3, 8, 36, 3), *, remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.remat = remat
        self.conv1 = Conv2d(3, 64, 7, 2, generator=generator)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if stage == 0 else 2
            stack = []
            for j in range(blocks):
                s = stride if j == 0 else 1
                downsample = j == 0 and (s != 1 or inplanes != planes * Bottleneck.expansion)
                stack.append(Bottleneck(inplanes, planes, s, downsample, generator=generator))
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*stack))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        if not use_remat(self.remat):
            return self.layer4(self.layer3(self.layer2(self.layer1(x))))
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = remat(block, x)
        return x


class ImageEncoder(nn.Module):
    """ResNet trunk + adaptive pool to N image embeddings (reference
    ``src/mmbt.py:15-45``): NHWC (B, H, W, 3) -> (B, N, 2048). The N
    embeddings are the pool grid's cells in row-major order, as the JAX
    package's reshape of its (B, oh, ow, C) pool gives them. Pixels are
    taken as they come, cast to ``dtype`` (the compute dtype, the JAX
    module's ``dtype``; None is the weights' fp32; uint8 is not normalised):
    the trunk's convolutions and BatchNorms and the pool run in it."""

    def __init__(self, num_image_embeds: int = 3, pool_mode: str = "avg",
                 layers: Sequence[int] = (3, 8, 36, 3), dtype: Optional[torch.dtype] = None, *,
                 remat: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        if pool_mode not in ("avg", "max"):
            raise ValueError(f"pool_mode must be 'avg' or 'max', got {pool_mode!r}")
        self.dtype = dtype
        self.num_image_embeds = num_image_embeds
        self.pool_mode = pool_mode
        self.model = ResNetTrunk(layers, remat=remat, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or self.model.conv1.weight.dtype
        feats = self.model(x.permute(0, 3, 1, 2).to(dtype).contiguous())
        n = self.num_image_embeds
        out_hw = (n, 1) if n in (1, 2, 3, 5, 7) else POOL_GRID[n]
        pool = F.adaptive_avg_pool2d if self.pool_mode == "avg" else F.adaptive_max_pool2d
        return pool(feats, out_hw).flatten(2).transpose(1, 2)
