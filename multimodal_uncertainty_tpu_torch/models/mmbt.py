"""MMBT: the supervised multimodal bitransformer, BERT + ResNet-152 (port of
``models/mmbt.py``).

A ResNet image encoder gives N image embeddings, projected into BERT's width
and wrapped as ``[CLS] img_1 .. img_N [SEP]`` with BERT's own word, position
and token-type tables and its embedding LayerNorm (one module, read by both
segments). The image segment (positions 0..N+1, token type 0) is followed by
the text segment (positions restarting at 0, the request's token types); the
BERT encoder, the tanh pooler over token 0 (the image segment's [CLS]) and a
linear head give the class logits.

The reference's four forwards (full, image-only, text-only, control) are one
forward under a boolean keep mask over the concatenated sequence: the mask
hides keys only, so every query is still computed, and token 0, which the
pooler reads, is kept by every variant.

Parameter names follow the reference module tree (``enc.txt_embeddings``,
``enc.img_embeddings.img_embeddings``, ``enc.img_encoder.model.<torchvision
names>``, ``enc.encoder.layer.{i}.<HF names>``, ``enc.pooler.dense``,
``clf``).

``dtype`` is the compute dtype (the JAX module's; bf16 under ``train
--bf16``, None is fp32): the ResNet runs in it from its input on, and the
two segments' embeddings are cast to it after their fp32 LayerNorm (the JAX
package's ``models/mmbt.py:144-145``, ``:166-167``), so BERT, the pooler and
the classifier run in it. Parameters and BatchNorm statistics stay fp32.
``remat`` (``train --remat``) rematerialises each ResNet bottleneck and each
BERT layer in training.

Training: plain cross-entropy on the logits, and the freeze schedule's two
subtrees, the image encoder and the BERT encoder (:func:`mmbt_frozen_subtrees`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from multimodal_uncertainty_tpu_torch.models.bert import (
    BertConfig,
    BertEmbeddings,
    BertEncoder,
    BertPooler,
)
from multimodal_uncertainty_tpu_torch.models.layers import Linear
from multimodal_uncertainty_tpu_torch.models.resnet_tv import Bottleneck, ImageEncoder
from multimodal_uncertainty_tpu_torch.ops.losses import plain_cross_entropy

IMG_HIDDEN = 512 * Bottleneck.expansion  # the ResNet trunk's output channels
CLS_TOKEN_ID, SEP_TOKEN_ID = 101, 102  # bert-base-uncased [CLS] and [SEP]


class ImageBertEmbeddings(nn.Module):
    """Project the image features to BERT's width and wrap them with the
    [CLS] / [SEP] word embeddings, positions 0..N+1 and token type 0, through
    the text segment's tables and LayerNorm (reference ``src/mmbt.py:47-83``)."""

    def __init__(self, c: BertConfig, dropout: float = 0.1, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.img_embeddings = Linear(IMG_HIDDEN, c.hidden_size, generator=generator)
        self.dropout = nn.Dropout(dropout)

    def forward(self, imgs: torch.Tensor, tables: BertEmbeddings) -> torch.Tensor:
        """(B, N, 2048) -> (B, N + 2, D)."""
        b, n, _ = imgs.shape
        word = tables.word_embeddings.weight
        d = word.shape[1]
        tokens = torch.cat([word[CLS_TOKEN_ID].expand(b, 1, d), self.img_embeddings(imgs),
                            word[SEP_TOKEN_ID].expand(b, 1, d)], dim=1)
        x = (tokens + tables.position_embeddings.weight[: n + 2]
             + tables.token_type_embeddings.weight[0])
        return self.dropout(tables.LayerNorm(x))


class MultimodalBertEncoder(nn.Module):
    """Reference ``src/mmbt.py:86-234`` with mask-based variants."""

    def __init__(
        self,
        config: BertConfig,
        num_image_embeds: int = 3,
        img_embed_pool_type: str = "avg",
        dropout: float = 0.1,
        resnet_layers: Sequence[int] = (3, 8, 36, 3),
        dtype: Optional[torch.dtype] = None,
        remat: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if SEP_TOKEN_ID >= config.vocab_size:
            raise ValueError(f"[CLS] {CLS_TOKEN_ID} / [SEP] {SEP_TOKEN_ID} index a word table "
                             f"of {config.vocab_size} rows")
        self.num_image_embeds = num_image_embeds
        self.dtype = dtype
        self.txt_embeddings = BertEmbeddings(config, generator=generator)
        self.img_embeddings = ImageBertEmbeddings(config, dropout, generator=generator)
        self.img_encoder = ImageEncoder(num_image_embeds, img_embed_pool_type, resnet_layers,
                                        dtype, remat=remat, generator=generator)
        self.encoder = BertEncoder(config, remat=remat, generator=generator)
        self.pooler = BertPooler(config, generator=generator)

    def forward(self, input_txt, attention_mask, segment, input_img,
                seq_keep_mask: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, L) token ids, text mask and token types, (B, H, W, 3) image,
        optional (B, N + 2 + L) bool keep mask -> pooled (B, D).
        ``dropout_generator`` feeds BERT's attention-probability dropout."""
        return self.encode(self.embed_image(input_img), input_txt, attention_mask, segment,
                           seq_keep_mask, dropout_generator)

    def embed_image(self, input_img: torch.Tensor) -> torch.Tensor:
        """The image segment: (B, H, W, 3) image -> ResNet -> pooled
        embeddings -> projection, wrapped in [CLS] / [SEP] -> (B, N + 2, D)
        in the compute dtype."""
        # fp32 under bf16 too: the fp32 [CLS] / [SEP] rows and tables promote the projection
        img_x = self.img_embeddings(self.img_encoder(input_img), self.txt_embeddings)
        return img_x if self.dtype is None else img_x.to(self.dtype)

    def encode(self, img_x, input_txt, attention_mask, segment,
               seq_keep_mask: Optional[torch.Tensor] = None,
               dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The BERT pass over the image segment ``img_x`` (from
        :meth:`embed_image`) and the text segment under the keep mask ->
        pooled (B, D). The robustness sweep embeds each image once and
        repeats its segment across the variants' rows."""
        txt_x = self.txt_embeddings(input_txt, segment, self.dtype)
        b = input_txt.shape[0]
        full_mask = torch.cat([torch.ones((b, img_x.shape[1]), dtype=torch.bool,
                                          device=input_txt.device),
                               attention_mask.bool()], dim=1)
        if seq_keep_mask is not None:
            full_mask = full_mask & seq_keep_mask
        encoded = self.encoder(torch.cat([img_x, txt_x], dim=1), full_mask, dropout_generator)
        return self.pooler(encoded)

    # keep masks of the ablation variants
    def img_only_mask(self, bsz: int, txt_len: int, device=None) -> torch.Tensor:
        """The image segment whole, no text."""
        n = self.num_image_embeds + 2
        mask = torch.zeros((bsz, n + txt_len), dtype=torch.bool, device=device)
        mask[:, :n] = True
        return mask

    def txt_only_mask(self, bsz: int, txt_len: int, device=None) -> torch.Tensor:
        """The image segment's [CLS] and the text (reference :178 keeps
        ``img_embed_out[:, :1]``)."""
        n = self.num_image_embeds + 2
        mask = torch.ones((bsz, n + txt_len), dtype=torch.bool, device=device)
        mask[:, 1:n] = False
        return mask


class MultimodalBertClf(nn.Module):
    """Reference ``src/mmbt.py:237-262``: encoder -> Linear(hidden, C)."""

    def __init__(
        self,
        config: BertConfig = BertConfig.base(),
        n_classes: int = 101,
        num_image_embeds: int = 3,
        img_embed_pool_type: str = "avg",
        dropout: float = 0.1,
        resnet_layers: Sequence[int] = (3, 8, 36, 3),
        dtype: Optional[torch.dtype] = None,
        remat: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.config = config
        self.enc = MultimodalBertEncoder(config, num_image_embeds, img_embed_pool_type, dropout,
                                         resnet_layers=resnet_layers, dtype=dtype,
                                         remat=remat, generator=generator)
        self.clf = Linear(config.hidden_size, n_classes, generator=generator)

    def forward(self, x: Tuple[torch.Tensor, ...],
                seq_keep_mask: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x = (txt ids, text mask, segment, NHWC image) -> (B, C) logits."""
        return self.clf(self.enc(*x, seq_keep_mask=seq_keep_mask,
                                 dropout_generator=dropout_generator))

    @staticmethod
    def compute_loss(y_hat: torch.Tensor, y: torch.Tensor, *, eval: bool = False) -> torch.Tensor:
        return plain_cross_entropy(y_hat, y, eval=eval)


def mmbt_frozen_subtrees(flags: Sequence[bool]) -> Tuple[str, ...]:
    """The module prefixes frozen under ``flags = (freeze_img, freeze_txt)``:
    the image encoder and the BERT encoder (reference ``src/framework.py:
    280-285``; the JAX package's ``mmbt_grad_mask_fn``)."""
    return tuple(name for name, frozen in zip(("enc.img_encoder", "enc.encoder"), flags)
                 if frozen)
