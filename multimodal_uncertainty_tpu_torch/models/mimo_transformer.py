"""MIMO transformer for the FashionMNIST four-view setup (port of
``models/mimo_transformer.py``).

Reference ``src/model.py:114-171``: each 14x14 quarter is one token (its 196
pixels projected to the hidden width), the E x C tokens run through the
CLIP-style encoder (``models/transformer.py``, with ``drop`` on the MLP where
the reference's quirk puts it), the token features are averaged over the
channel axis, and head i reads view i's features; the heads run as one
batched einsum. With one channel a view that is S = E tokens, no key mask:
on the card the attention is the kernel of ``attention_qkv_packed`` at S = 4.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodal_uncertainty_tpu_torch.models.layers import EnsembleHeads, LayerNormFP32, Linear
from multimodal_uncertainty_tpu_torch.models.transformer import Transformer
from multimodal_uncertainty_tpu_torch.ops.losses import mimo_cross_entropy


class MIMOTransformer(nn.Module):
    def __init__(self, out_dim: int = 4, num_classes: int = 10, hidden_size: int = 768,
                 image_dim: int = 14 * 14, multimodal_num_hidden_layers: int = 3,
                 multimodal_num_attention_heads: int = 3, drop: float = 0.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim, self.hidden_size = out_dim, hidden_size
        self.image_to_mm_projection = Linear(image_dim, hidden_size, generator=generator)
        self.ln_pre = LayerNormFP32(hidden_size)
        self.mm_encoder = Transformer(hidden_size, multimodal_num_hidden_layers,
                                      multimodal_num_attention_heads, drop, generator=generator)
        self.ln_post = LayerNormFP32(hidden_size)
        self.output_layers = EnsembleHeads(hidden_size, num_classes, out_dim,
                                           generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, E, C, H, W) -> logits (B, out_dim, num_classes)."""
        b, e, c, h, w = x.shape
        x = x.reshape(b, e * c, h * w).to(self.image_to_mm_projection.weight.dtype)
        x = self.ln_post(self.mm_encoder(self.ln_pre(self.image_to_mm_projection(x))))
        x = x.reshape(b, e, c, self.hidden_size).mean(dim=2)  # (B, E, D)
        return self.output_layers(x[:, :self.out_dim, :])

    @staticmethod
    def compute_loss(y_hat, y, *, eval: bool = False):
        return mimo_cross_entropy(y_hat, y, eval=eval)


# the reference's spelling (``MIMOTransfomer``, src/model.py:114)
MIMOTransfomer = MIMOTransformer
