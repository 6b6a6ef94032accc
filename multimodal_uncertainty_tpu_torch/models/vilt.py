"""ViLT: single-stream patch-embedding fusion classifier (port of ``models/vilt.py``).

The reference's HF ``ViltForImagesAndTextClassification`` (``train.py:166-169``)
as the JAX package builds it: BERT-style text embeddings with their
LayerNorm, 32x32 image patches (a stride-32 convolution) with positions
bilinearly interpolated to each sample's pixel-mask grid, a modality table
separate from the token-type table (text 0, image 1), pre-LN ViT blocks with
eps 1e-12 and exact GELU, a final LayerNorm, a first-token tanh pooler and the
Linear -> LayerNorm(eps 1e-5) -> GELU -> Linear head.

Module and parameter names follow the JAX module one to one (``block_i`` is
``block.i``; the packed ``qkv``; ``cls_fc`` / ``cls_ln`` / ``cls_out``), so
:func:`~multimodal_uncertainty_tpu_torch.models.jax_import.vilt_state_dict_from_jax`
carries its weights over. The patch convolution's kernel is OIHW here (flax's
is HWIO). Attention runs on the packed QKV (``attention_qkv_packed``), or,
in training with ``attention_probs_dropout_prob > 0``, on the separate q, k,
v with dropout on the probabilities.

Weights are drawn from an explicit ``torch.Generator``: embeddings N(0, 0.02),
Linears torch's default, the patch convolution flax's LeCun truncated normal
and a zero bias, as the JAX model initialises them. The model is fp32 (the
JAX config's bf16 ``dtype`` is not ported).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_uncertainty_tpu_torch.models.layers import LayerNormFP32, Linear
from multimodal_uncertainty_tpu_torch.ops.attention import (
    attention_heads_last_dropout,
    attention_qkv_packed,
)
from multimodal_uncertainty_tpu_torch.ops.losses import softmax_cross_entropy


@dataclasses.dataclass(frozen=True)
class ViltConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 40
    type_vocab_size: int = 2
    image_size: int = 384
    patch_size: int = 32
    num_labels: int = 2
    num_images: int = 1
    dropout: float = 0.0
    # > 0: dropout on the attention probabilities in training (HF ViLT's regime)
    attention_probs_dropout_prob: float = 0.0
    layer_norm_eps: float = 1e-12

    @staticmethod
    def b32() -> "ViltConfig":
        return ViltConfig()


@dataclasses.dataclass
class ViltOutput:
    loss: Optional[torch.Tensor]
    logits: torch.Tensor


def _normal(shape, std: float, generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).normal_(0.0, std, generator=generator))


def _lecun_normal(shape, fan_in: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at 2 std, scaled to variance
    1 / fan_in (drawn by the inverse CDF)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # the std of N(0, 1) cut at +-2
    edge = math.erf(2.0 / math.sqrt(2.0))  # erfinv maps (-edge, edge) onto z / sqrt(2), |z| < 2
    u = torch.empty(shape).uniform_(-edge, edge, generator=generator)
    return torch.erfinv(u) * (math.sqrt(2.0) * std)


class ViTBlock(nn.Module):
    """Pre-LN block: x + proj(attn(ln_1 x)), then x + fc2(gelu(fc1(ln_2 x)))."""

    def __init__(self, c: ViltConfig, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        d = c.hidden_size
        self.n_head = c.num_attention_heads
        self.probs_dropout = c.attention_probs_dropout_prob
        self.ln_1 = LayerNormFP32(d, c.layer_norm_eps)
        self.qkv = Linear(d, 3 * d, generator=generator)
        self.proj = Linear(d, d, generator=generator)
        self.ln_2 = LayerNormFP32(d, c.layer_norm_eps)
        self.fc1 = Linear(d, c.intermediate_size, generator=generator)
        self.fc2 = Linear(c.intermediate_size, d, generator=generator)
        self.dropout = nn.Dropout(c.dropout)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        qkv = self.qkv(self.ln_1(x))
        if self.training and self.probs_dropout > 0.0:
            d = x.shape[-1]
            attn = attention_heads_last_dropout(
                qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], key_mask,
                n_head=self.n_head, rate=self.probs_dropout, generator=dropout_generator)
        else:
            attn = attention_qkv_packed(qkv, key_mask, n_head=self.n_head)
        x = x + self.proj(attn)
        y = F.gelu(self.fc1(self.ln_2(x)))
        return x + self.fc2(self.dropout(y))


def _interp_coords(n_out: int, eff: torch.Tensor, g0: int):
    """Bilinear sample coordinates (align_corners) of ``n_out`` outputs over a
    ``g0`` grid for effective sizes ``eff`` (B,): (lo, hi, frac), each (B,
    n_out), in the JAX model's fp32 arithmetic."""
    s = (torch.arange(n_out, dtype=torch.float32, device=eff.device)[None] * (g0 - 1)
         / torch.clamp(eff[:, None] - 1.0, min=1.0))
    s = torch.clamp(s, 0.0, g0 - 1.0)
    lo = torch.floor(s).to(torch.int64)
    hi = torch.clamp(lo + 1, max=g0 - 1)
    return lo, hi, s - lo


class ViltModel(nn.Module):
    """Embeddings, encoder, final LayerNorm and pooler: -> (sequence, pooled)."""

    def __init__(self, c: ViltConfig, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        d, p = c.hidden_size, c.patch_size
        self.config = c
        self.word_embeddings = _normal((c.vocab_size, d), 0.02, generator)
        self.position_embeddings = _normal((c.max_position_embeddings, d), 0.02, generator)
        self.token_type_embeddings = _normal((c.type_vocab_size, d), 0.02, generator)
        self.emb_LayerNorm = LayerNormFP32(d, c.layer_norm_eps)
        self.patch_embed = nn.Conv2d(3, d, p, stride=p, padding=0)
        with torch.no_grad():
            self.patch_embed.weight.copy_(_lecun_normal((d, 3, p, p), 3 * p * p, generator))
            self.patch_embed.bias.zero_()
        g0 = c.image_size // p
        self.image_position_embeddings = _normal((g0 * g0 + 1, d), 0.02, generator)
        self.image_cls = _normal((1, 1, d), 0.02, generator)
        self.modality_type_embeddings = _normal((2, d), 0.02, generator)
        self.block = nn.ModuleList(ViTBlock(c, generator=generator)
                                   for _ in range(c.num_hidden_layers))
        self.ln_post = LayerNormFP32(d, c.layer_norm_eps)
        self.pooler = Linear(d, d, generator=generator)
        self.dropout = nn.Dropout(c.dropout)

    def _patch_positions(self, patch_keep: torch.Tensor, gh: int, gw: int,
                         interpolate: bool) -> torch.Tensor:
        """(B, gh*gw, D) positions: the table itself, or HF's bilinear
        interpolation of the g0 x g0 table to each sample's effective (h_i,
        w_i) patch grid, taken from the keep mask's first column and first
        row (a top-left rectangle). Positions past (h_i, w_i) are clamped
        values under the attention mask."""
        c = self.config
        b, d = patch_keep.shape[0], c.hidden_size
        g0 = c.image_size // c.patch_size
        table = self.image_position_embeddings
        if not interpolate:
            return table[None, 1:].expand(b, gh * gw, d)
        grid = table[1:].reshape(g0, g0, d)
        h_i = patch_keep[:, :, 0].sum(dim=1).to(torch.float32)
        w_i = patch_keep[:, 0, :].sum(dim=1).to(torch.float32)
        r0, r1, fr = _interp_coords(gh, h_i, g0)  # (B, gh)
        c0, c1, fc = _interp_coords(gw, w_i, g0)  # (B, gw)

        def gat(r, cc):  # -> (B, gh, gw, D)
            return grid[r[:, :, None], cc[:, None, :]]

        wr0, wr1 = (1.0 - fr)[..., None, None], fr[..., None, None]
        wc0, wc1 = (1.0 - fc)[:, None, :, None], fc[:, None, :, None]
        pos = (gat(r0, c0) * wr0 * wc0 + gat(r0, c1) * wr0 * wc1
               + gat(r1, c0) * wr1 * wc0 + gat(r1, c1) * wr1 * wc1)
        return pos.reshape(b, gh * gw, d)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor, pixel_values: torch.Tensor,
                pixel_mask: Optional[torch.Tensor] = None, *,
                dropout_generator: Optional[torch.Generator] = None):
        c = self.config
        b, lt = input_ids.shape
        if lt > c.max_position_embeddings:
            raise ValueError(f"ViLT text of {lt} tokens: the position table has "
                             f"{c.max_position_embeddings} rows")
        d, p = c.hidden_size, c.patch_size
        txt = (self.word_embeddings[input_ids] + self.position_embeddings[:lt][None]
               + self.token_type_embeddings[token_type_ids])
        txt = self.dropout(self.emb_LayerNorm(txt))

        # pixel_values arrive NCHW (HF's convention) or NHWC, or (B, 1, C, H, W)
        if pixel_values.dim() == 5:
            pixel_values = pixel_values[:, 0]
        if pixel_values.shape[1] != 3:
            pixel_values = pixel_values.permute(0, 3, 1, 2)
        patches = self.patch_embed(pixel_values.to(self.patch_embed.weight.dtype))
        gh, gw = patches.shape[2], patches.shape[3]
        img = patches.flatten(2).transpose(1, 2)  # (B, gh*gw, D), row-major patches

        # patch keep mask: any live pixel keeps its patch
        if pixel_mask is not None:
            if pixel_mask.dim() == 4:
                pixel_mask = pixel_mask[:, 0]
            pm = pixel_mask.reshape(b, gh, p, gw, p)
            patch_keep = pm.amax(dim=(2, 4)) > 0
        else:
            patch_keep = torch.ones((b, gh, gw), dtype=torch.bool, device=img.device)
        g0 = c.image_size // p
        interpolate = pixel_mask is not None or (gh, gw) != (g0, g0)
        img = img + self._patch_positions(patch_keep, gh, gw, interpolate)
        cls = (self.image_cls + self.image_position_embeddings[0]).expand(b, 1, d)
        img = self.dropout(torch.cat([cls, img], dim=1))

        txt = txt + self.modality_type_embeddings[0]
        img = img + self.modality_type_embeddings[1]
        x = torch.cat([txt, img], dim=1)
        mask = torch.cat([attention_mask.to(torch.bool),
                          torch.ones((b, 1), dtype=torch.bool, device=x.device),
                          patch_keep.reshape(b, gh * gw)], dim=1)
        for blk in self.block:
            x = blk(x, mask, dropout_generator)
        x = self.ln_post(x)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class ViltForImagesAndTextClassification(nn.Module):
    """HF-shaped interface: called with the processor batch dict (``input_ids``,
    ``attention_mask``, optional ``token_type_ids``, ``pixel_values``,
    optional ``pixel_mask`` and ``labels``); returns ``ViltOutput(loss,
    logits)``."""

    def __init__(self, config: ViltConfig, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        self.config = c
        h = c.hidden_size * c.num_images
        self.vilt = ViltModel(c, generator=generator)
        self.cls_fc = Linear(h, h, generator=generator)
        self.cls_ln = LayerNormFP32(h, 1e-5)  # torch nn.LayerNorm's default
        self.cls_out = Linear(h, c.num_labels, generator=generator)

    def forward(self, batch: dict, *,
                dropout_generator: Optional[torch.Generator] = None) -> ViltOutput:
        ids = batch["input_ids"]
        token_types = batch.get("token_type_ids")
        _, pooled = self.vilt(
            ids, batch["attention_mask"], ids * 0 if token_types is None else token_types,
            batch["pixel_values"], batch.get("pixel_mask"), dropout_generator=dropout_generator)
        h = F.gelu(self.cls_ln(self.cls_fc(pooled)))
        logits = self.cls_out(h)
        labels = batch.get("labels")
        loss = None if labels is None else softmax_cross_entropy(logits, labels.reshape(-1))
        return ViltOutput(loss=loss, logits=logits)
