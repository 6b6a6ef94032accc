"""FLAVA-embedding fusion transformer (port of ``models/fusion.py``).

Projects precomputed FLAVA image and text embedding sequences into a shared
width, concatenates them, runs a small CLIP-style encoder and reads E
ensemble heads off designated tokens.

Modality ablation and padding are keep-masks, not token slicing: masked keys
get exactly zero softmax weight, which equals removing the tokens. Head *i*
reads the i-th *kept* token (stable argsort of the mask), as the reference's
head *i* reads position *i* of the sliced sequence.

``dtype`` is the compute dtype (the JAX module's ``dtype``; bf16 under
``train --bf16``): the features are cast to it before the projections, and
everything after runs in it (LayerNorm in fp32 inside), the logits included.
Parameters stay fp32 whatever it is. ``remat`` rematerialises the encoder's
blocks in training (``train --remat``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from multimodal_uncertainty_tpu_torch.models.layers import EnsembleHeads, LayerNormFP32, Linear
from multimodal_uncertainty_tpu_torch.models.transformer import Transformer


def _kept_token_gather(out: torch.Tensor, mask: Optional[torch.Tensor], e: int) -> torch.Tensor:
    """(B, L, D) -> (B, E, D): the first ``e`` kept tokens of each sequence."""
    if mask is None:
        return out[:, :e, :]
    # stable argsort moves the kept positions (mask True) to the front, in order
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    idx = order[:, :e]
    return torch.gather(out, 1, idx[..., None].expand(-1, -1, out.shape[-1]))


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, L, D) -> (B, D) mean over kept tokens (all tokens if mask is None)."""
    if mask is None:
        return x.mean(dim=1)
    m = mask.to(x.dtype)[..., None]
    cnt = torch.clamp(m.sum(dim=1), min=1.0)
    return (x * m).sum(dim=1) / cnt


class FlavaFusionTransformer(nn.Module):
    """Fusion transformer over precomputed FLAVA embeddings."""

    def __init__(
        self,
        out_dim: int = 1,
        num_classes: int = 2,
        image_hidden_size: int = 768,
        text_hidden_size: int = 768,
        multimodal_hidden_size: int = 768,
        multimodal_num_attention_heads: int = 3,
        multimodal_num_hidden_layers: int = 3,
        drop: float = 0.0,
        avg_pool: bool = False,
        cls_token: bool = False,
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        d = multimodal_hidden_size
        self.dtype = dtype
        self.out_dim = out_dim
        self.avg_pool = avg_pool
        self.cls_token = cls_token
        self.image_to_mm_projection = Linear(image_hidden_size, d, generator=generator)
        self.text_to_mm_projection = Linear(text_hidden_size, d, generator=generator)
        if cls_token:
            # (D, E) scaled randn, the reference's learned per-head CLS tokens
            self.class_embeddings = nn.Parameter(
                d**-0.5 * torch.randn((d, out_dim), generator=generator)
            )
        self.ln_pre = LayerNormFP32(d)
        self.mm_encoder = Transformer(
            d, multimodal_num_hidden_layers, multimodal_num_attention_heads, drop,
            remat=remat, generator=generator,
        )
        self.ln_post = LayerNormFP32(d)
        self.output_layers = EnsembleHeads(d, num_classes, out_dim, generator=generator)

    def forward(
        self,
        x: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
        *,
        img_mask: Optional[torch.Tensor] = None,
        txt_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """(image (B, L_i, D_i) | None, text (B, L_t, D_t) | None) -> logits (B, E, C)."""
        image_features, text_features = x
        parts, masks = [], []
        any_mask = img_mask is not None or txt_mask is not None
        ref = image_features if image_features is not None else text_features
        b, device = ref.shape[0], ref.device

        l_img = l_txt = 0
        if image_features is not None:
            parts.append(self.image_to_mm_projection(image_features.to(self.dtype)))
            l_img = image_features.shape[1]
            masks.append(img_mask if img_mask is not None
                         else torch.ones((b, l_img), dtype=torch.bool, device=device))
        if text_features is not None:
            parts.append(self.text_to_mm_projection(text_features.to(self.dtype)))
            l_txt = text_features.shape[1]
            masks.append(txt_mask if txt_mask is not None
                         else torch.ones((b, l_txt), dtype=torch.bool, device=device))

        mm_x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        mask = torch.cat(masks, dim=1) if any_mask else None

        n_cls = 0
        if self.cls_token:
            cls = self.class_embeddings.t().to(mm_x.dtype)[None].expand(b, -1, -1)
            mm_x = torch.cat([cls, mm_x], dim=1)
            if mask is not None:
                mask = torch.cat(
                    [torch.ones((b, self.out_dim), dtype=torch.bool, device=device), mask], dim=1
                )
            n_cls = self.out_dim

        out = self.ln_post(self.mm_encoder(self.ln_pre(mm_x), mask))

        if self.avg_pool and not self.cls_token:
            # head 0 pools the image segment, head 1 the text segment
            img_m = mask[:, :l_img] if mask is not None else None
            txt_m = mask[:, l_img:l_img + l_txt] if mask is not None else None
            pooled = []
            if l_img:
                pooled.append(_masked_mean(out[:, :l_img], img_m))
            if l_txt:
                pooled.append(_masked_mean(out[:, l_img:l_img + l_txt], txt_m))
            while len(pooled) < self.out_dim:  # missing modality at eval
                pooled.append(pooled[-1])
            tokens = torch.stack(pooled[: self.out_dim], dim=1)
        elif n_cls:
            tokens = out[:, : self.out_dim]  # CLS positions, always kept
        else:
            tokens = _kept_token_gather(out, mask, self.out_dim)
        return self.output_layers(tokens)


def flava_fusion_with_cls_token(**kwargs) -> FlavaFusionTransformer:
    """The reference's ``FlavaFusionTransfomerwithCLSToken``: learned per-head
    CLS tokens prepended, heads read the E CLS positions. Default drop=0.1."""
    kwargs.setdefault("drop", 0.1)
    return FlavaFusionTransformer(cls_token=True, **kwargs)
