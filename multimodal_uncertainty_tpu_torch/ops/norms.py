"""LayerNorm with fp32 internals (port of ``ops/norms.py::layer_norm_xla``).

Inputs of any float dtype are normalised in fp32 and cast back, the
reference's fp16-safe LayerNorm contract.
"""
from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)
