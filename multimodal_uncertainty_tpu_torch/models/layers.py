"""Shared layers (port of ``models/layers.py``): Linear with torch-default
init, fp32 LayerNorm, QuickGELU, batched ensemble heads, the fused
multi-head output layer, and the ResNets' convolution, BatchNorm and
BasicBlock.

Every initialiser draws from an explicit ``torch.Generator``, so a model is a
function of its seed. Weights live in fp32; matmuls and convolutions run in
the activation dtype (bf16 under ``train --bf16``), the weight cast to it, as
in the JAX package, whose Linears on these paths take no dtype of their own.
LayerNorm and BatchNorm compute in fp32 inside and return the input's dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from multimodal_uncertainty_tpu_torch.models.remat import recomputing
from multimodal_uncertainty_tpu_torch.ops.dw import TILE as DW_TILE
from multimodal_uncertainty_tpu_torch.ops.dw import linear_dw
from multimodal_uncertainty_tpu_torch.ops.norms import layer_norm, layer_norm_kernel
from multimodal_uncertainty_tpu_torch.ops.quant import (
    check_mode,
    int8_dot_q,
    int8_weight_dot_q,
    weight_int8,
)


def _uniform(shape, bound: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


class Linear(nn.Module):
    """``y = x W^T + b``; W is (out, in) as in ``torch.nn.Linear``, drawn
    from U(-1/sqrt(in), 1/sqrt(in)) like torch's default (the JAX package
    keeps the transpose, (in, out)).

    ``fast_dw`` (off by default; :func:`set_fast_dw` sets it, ``train
    --fast_dw``): in training mode a Linear whose in and out widths are both
    multiples of 128 computes its weight gradient with the dW kernel
    (:func:`~multimodal_uncertainty_tpu_torch.ops.dw.linear_dw`), the JAX
    package's rule (``models/layers.py:68-74``). The forward is the same
    product; eval and serving never take the route.

    ``quantize`` (None by default; :func:`set_quantize` sets it, ``predict
    --quantize``): ``"int8"`` or ``"int8_weight"`` runs the product on the
    int8 weight that :func:`set_quantize` stored (``weight_q``, per-channel
    ``weight_scale``) by :mod:`~multimodal_uncertainty_tpu_torch.ops.quant`,
    then adds the bias in the output's dtype (``models/layers.py:66-67``). It
    takes precedence over ``fast_dw``, as in JAX."""

    def __init__(self, in_features: int, out_features: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(_uniform((out_features, in_features), bound, generator))
        self.bias = nn.Parameter(_uniform((out_features,), bound, generator))
        self.fast_dw = False
        self.quantize = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantize is not None:
            dot = int8_dot_q if self.quantize == "int8" else int8_weight_dot_q
            y = dot(x, self.weight_q, self.weight_scale)
            return y + self.bias.to(y.dtype)
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if (self.fast_dw and self.training and w.shape[0] % DW_TILE == 0
                and w.shape[1] % DW_TILE == 0):
            return linear_dw(x, w) + b
        return nn.functional.linear(x, w, b)


def set_fast_dw(model: nn.Module, on: bool) -> None:
    """Set every :class:`Linear`'s ``fast_dw`` flag in ``model``."""
    for m in model.modules():
        if isinstance(m, Linear):
            m.fast_dw = bool(on)


def set_quantize(model: nn.Module, mode: Optional[str]) -> None:
    """Set every :class:`Linear`'s ``quantize`` mode in ``model``: ``"int8"``,
    ``"int8_weight"`` or None. A mode quantizes each weight once, as it is
    now, into the non-persistent buffers ``weight_q`` / ``weight_scale`` on
    its device (the state dict does not change); None drops them. Serving
    sets it on a built predictor's model: the mode is an attribute, so the
    forward reads it in whatever thread runs it."""
    check_mode(mode)
    for m in model.modules():
        if not isinstance(m, Linear):
            continue
        m.quantize = mode
        if mode is None:
            m.weight_q = m.weight_scale = None
            continue
        with torch.no_grad():
            wq, ws = weight_int8(m.weight)
        m.register_buffer("weight_q", wq, persistent=False)
        m.register_buffer("weight_scale", ws, persistent=False)


class LayerNormFP32(nn.Module):
    """LayerNorm computed in fp32 whatever the activation dtype.

    ``impl`` is the JAX module's attribute: ``"plain"`` (the default, its
    ``"xla"``) runs :func:`~multimodal_uncertainty_tpu_torch.ops.norms.layer_norm`;
    ``"kernel"`` (its ``"pallas"``) runs the forward-only LayerNorm kernel
    (:func:`~multimodal_uncertainty_tpu_torch.ops.norms.layer_norm_kernel`),
    which raises where a gradient is needed. No CLI flag sets it, as in JAX:
    a caller assigns it on a built model."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.impl = "plain"
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl == "kernel":
            return layer_norm_kernel(x, self.weight, self.bias, self.eps)
        return layer_norm(x, self.weight, self.bias, self.eps)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class EnsembleHeads(nn.Module):
    """``out_dim`` independent Linear heads on ``out_dim`` token vectors, as
    one batched einsum: (B, E, D) -> (B, E, C). ``kernel`` is (E, D, C) and
    ``bias`` (E, C), the JAX package's layout."""

    def __init__(self, dim: int, num_classes: int, out_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(dim)
        self.kernel = nn.Parameter(torch.stack(
            [_uniform((dim, num_classes), bound, generator) for _ in range(out_dim)]
        ))
        self.bias = nn.Parameter(torch.stack(
            [_uniform((num_classes,), bound, generator) for _ in range(out_dim)]
        ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (torch.einsum("bed,edc->bec", x, self.kernel.to(x.dtype))
                + self.bias.to(x.dtype))


class MultiHeadFC(nn.Module):
    """One fused Linear of ``num_classes * out_dim`` outputs reshaped to (B,
    E, C): logit ``e * C + c`` is head e's class c (reference
    ``src/model.py:58-70``, whose split and stack equal the reshape)."""

    def __init__(self, in_features: int, num_classes: int, out_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes, self.out_dim = num_classes, out_dim
        self.fc = Linear(in_features, num_classes * out_dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x).reshape(x.shape[0], self.out_dim, self.num_classes)


class Conv2d(nn.Conv2d):
    """Bias-free NCHW convolution with torch's symmetric ``k // 2`` padding
    (not XLA's "SAME", which pads a stride-2 3x3 on the high side only) and
    the reference ResNet's He-normal fan-out init (std sqrt(2 / (out k k))).
    Runs as ``F.conv2d`` in the input's dtype, the fp32 weight cast to it
    (flax's ``Conv(dtype=)``); the JAX package leaves its convolutions to XLA."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, *, generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding=kernel_size // 2, bias=False)
        std = math.sqrt(2.0 / (out_channels * kernel_size * kernel_size))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), None)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over NCHW with torch's defaults: eps 1e-5, momentum 0.1
    (flax's ``momentum=0.9`` is the weight of the old running statistic, so
    the same update). Eval reads the running statistics.

    Training normalises by the batch statistics and updates the running
    variance with the **biased** batch variance, the JAX package's flax
    convention, where ``nn.BatchNorm2d`` takes the unbiased one (a factor
    n / (n - 1), large at small batches).

    A bf16 input is normalised in fp32 against the fp32 parameters and
    running statistics and returned in bf16; the batch statistics are
    computed from its values promoted to at least fp32, as flax's
    ``BatchNorm(dtype=bf16)`` does. The recompute of a rematerialised block
    (``models/remat.py``) normalises the same way and leaves the running
    statistics alone: they move once a step, as without remat."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        out = nn.functional.batch_norm(x, None, None, self.weight, self.bias, training=True,
                                       eps=self.eps)
        if recomputing():
            return out
        with torch.no_grad():
            xs = x.to(torch.promote_types(x.dtype, torch.float32))  # bf16 -> fp32, as flax
            var, mean = torch.var_mean(xs, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return out


class BasicBlock(nn.Module):
    """ResNet BasicBlock (reference ``src/layers.py:7-38``), NCHW: two 3x3
    convolutions (the stride on the first) with BatchNorm, and a 1x1
    convolution with BatchNorm on the shortcut when ``downsample``."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, generator=generator)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, generator=generator)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (
            nn.Sequential(Conv2d(inplanes, planes * self.expansion, 1, stride,
                                 generator=generator),
                          BatchNorm2d(planes * self.expansion))
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = nn.functional.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return nn.functional.relu(out + residual)
