"""CLIP-style pre-LN transformer encoder (port of ``models/transformer.py``).

The attention core is :func:`~multimodal_uncertainty_tpu_torch.ops.attention.
attention_qkv_packed`: the hand-written CUDA kernel on the card, its plain
version on the CPU.

Quirk kept from the reference: its MLP is an OrderedDict with a duplicate
"dropout" key, so one dropout survives, between c_fc and the activation:
c_fc -> dropout -> QuickGELU -> c_proj.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodal_uncertainty_tpu_torch.models.layers import LayerNormFP32, Linear, quick_gelu
from multimodal_uncertainty_tpu_torch.models.remat import remat, use_remat
from multimodal_uncertainty_tpu_torch.ops.attention import attention_qkv_packed


class MultiHeadAttention(nn.Module):
    """Self-attention with a packed QKV projection (in_proj 3D x D in
    q | k | v order, out_proj D x D), heads-packed (B, S, D) end to end."""

    def __init__(self, dim: int, n_head: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim % n_head:
            raise ValueError(f"width {dim} not divisible by {n_head} heads")
        self.n_head = n_head
        self.in_proj = Linear(dim, 3 * dim, generator=generator)
        self.out_proj = Linear(dim, dim, generator=generator)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None):
        out = attention_qkv_packed(self.in_proj(x), key_mask, n_head=self.n_head)
        return self.out_proj(out)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, dim: int, n_head: int, drop: float = 0.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ln_1 = LayerNormFP32(dim)
        self.attn = MultiHeadAttention(dim, n_head, generator=generator)
        self.ln_2 = LayerNormFP32(dim)
        self.c_fc = Linear(dim, 4 * dim, generator=generator)
        self.dropout = nn.Dropout(drop)
        self.c_proj = Linear(4 * dim, dim, generator=generator)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None):
        x = x + self.attn(self.ln_1(x), key_mask)
        h = quick_gelu(self.dropout(self.c_fc(self.ln_2(x))))
        return x + self.c_proj(h)


class Transformer(nn.Module):
    """``layers`` blocks. ``remat``: each block is rematerialised in training
    (``models/remat.py``), trading a second forward of its attention in the
    backward for the activations it would keep."""

    def __init__(self, dim: int, layers: int, heads: int, drop: float = 0.0, *,
                 remat: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.remat = remat
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(dim, heads, drop, generator=generator)
            for _ in range(layers)
        )

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None):
        on = use_remat(self.remat)
        for block in self.resblocks:
            x = remat(block, x, key_mask) if on else block(x, key_mask)
        return x
