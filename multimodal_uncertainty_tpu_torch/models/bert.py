"""BERT encoder for the MMBT path (port of ``models/bert.py``).

``pytorch_pretrained_bert``'s ``BertModel`` (bert-base / bert-large):
post-LN self-attention blocks, erf-GELU intermediate, LayerNorm eps 1e-12,
first-token tanh pooler. Parameter names are HF's
(``encoder.layer.{i}.attention.self.query``, ``attention.output.dense``,
``attention.output.LayerNorm``, ``intermediate.dense``, ``output.dense``,
``output.LayerNorm``, ``pooler.dense``), so a BERT state dict loads without
a mapping.

Every block runs in its input's dtype (bf16 under MMBT's ``--bf16``):
``BertLayerNorm`` is :class:`~multimodal_uncertainty_tpu_torch.models.layers.
LayerNormFP32` (fp32 inside), GELU is erf-exact, and the residual sums stay
in the activation dtype.

Self-attention is :func:`~multimodal_uncertainty_tpu_torch.ops.attention.
attention_heads_last` on the three separate projections: the hand-written
CUDA kernels on the card, their plain versions on the CPU. In training with
``attention_probs_dropout_prob > 0`` (torch BERT's 0.1; the JAX default is 0)
it is ``attention_heads_last_dropout``, each layer drawing its keep mask from
the generator the forward is given.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_uncertainty_tpu_torch.models.layers import LayerNormFP32, Linear
from multimodal_uncertainty_tpu_torch.models.remat import remat, use_remat
from multimodal_uncertainty_tpu_torch.ops.attention import (
    attention_heads_last,
    attention_heads_last_dropout,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    # 0 keeps training attention on K2 (the JAX default); > 0 is torch BERT's
    # regulariser on the attention probabilities (K5)
    attention_probs_dropout_prob: float = 0.0
    layer_norm_eps: float = 1e-12

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def large() -> "BertConfig":
        return BertConfig(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                          intermediate_size=4096)


def _normal_table(rows: int, dim: int, generator: Optional[torch.Generator]) -> nn.Embedding:
    table = nn.Embedding(rows, dim)
    with torch.no_grad():
        table.weight.normal_(0.0, 0.02, generator=generator)
    return table


class BertEmbeddings(nn.Module):
    """word + position + token-type tables and their LayerNorm. MMBT reads
    the same tables and LayerNorm for its image segment (one module, used
    twice)."""

    def __init__(self, c: BertConfig, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.word_embeddings = _normal_table(c.vocab_size, c.hidden_size, generator)
        self.position_embeddings = _normal_table(c.max_position_embeddings, c.hidden_size,
                                                 generator)
        self.token_type_embeddings = _normal_table(c.type_vocab_size, c.hidden_size, generator)
        self.LayerNorm = LayerNormFP32(c.hidden_size, c.layer_norm_eps)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(B, L) ids and token types -> (B, L, D); positions restart at 0.
        The sum and its LayerNorm are fp32; ``dtype`` (MMBT's compute dtype)
        casts the normalised rows before the dropout, as the JAX package's
        MMBT does (``models/mmbt.py:144-145``)."""
        pos = self.position_embeddings.weight[: input_ids.shape[1]]
        x = self.word_embeddings(input_ids) + pos + self.token_type_embeddings(token_type_ids)
        x = self.LayerNorm(x)
        return self.dropout(x if dtype is None else x.to(dtype))


class BertSelfAttention(nn.Module):
    def __init__(self, c: BertConfig, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        d = c.hidden_size
        if d % c.num_attention_heads:
            raise ValueError(f"width {d} not divisible by {c.num_attention_heads} heads")
        self.n_head = c.num_attention_heads
        self.probs_dropout = c.attention_probs_dropout_prob
        self.query = Linear(d, d, generator=generator)
        self.key = Linear(d, d, generator=generator)
        self.value = Linear(d, d, generator=generator)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor],
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)
        if self.training and self.probs_dropout > 0.0:
            return attention_heads_last_dropout(q, k, v, key_mask, n_head=self.n_head,
                                                rate=self.probs_dropout,
                                                generator=dropout_generator)
        return attention_heads_last(q, k, v, key_mask, n_head=self.n_head)


class _DenseResidualNorm(nn.Module):
    """dense -> dropout -> LayerNorm(residual + .): HF's ``BertSelfOutput``
    and ``BertOutput``."""

    def __init__(self, d_in: int, c: BertConfig, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = Linear(d_in, c.hidden_size, generator=generator)
        self.LayerNorm = LayerNormFP32(c.hidden_size, c.layer_norm_eps)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(self, h: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(residual + self.dropout(self.dense(h)))


class BertAttention(nn.Module):
    def __init__(self, c: BertConfig, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.self = BertSelfAttention(c, generator=generator)
        self.output = _DenseResidualNorm(c.hidden_size, c, generator=generator)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor],
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.output(self.self(x, key_mask, dropout_generator), x)


class BertIntermediate(nn.Module):
    def __init__(self, c: BertConfig, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = Linear(c.hidden_size, c.intermediate_size, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.dense(x))  # erf GELU, as BERT


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.attention = BertAttention(c, generator=generator)
        self.intermediate = BertIntermediate(c, generator=generator)
        self.output = _DenseResidualNorm(c.intermediate_size, c, generator=generator)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.attention(x, key_mask, dropout_generator)
        return self.output(self.intermediate(x), x)


class BertEncoder(nn.Module):
    """``remat``: each layer is rematerialised in training, its recompute
    drawing the same attention keep mask from ``dropout_generator``
    (``models/remat.py``)."""

    def __init__(self, c: BertConfig, *, remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.remat = remat
        self.layer = nn.ModuleList(BertLayer(c, generator=generator)
                                   for _ in range(c.num_hidden_layers))

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        on = use_remat(self.remat)
        for layer in self.layer:
            x = (remat(layer, x, key_mask, dropout_generator, generator=dropout_generator)
                 if on else layer(x, key_mask, dropout_generator))
        return x


class BertPooler(nn.Module):
    """tanh(dense(first token))."""

    def __init__(self, c: BertConfig, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = Linear(c.hidden_size, c.hidden_size, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(x[:, 0]))
