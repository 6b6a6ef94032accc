"""Pretrained-weight import: torch state dicts into the port's MMBT and ViLT
(port of ``models/torch_import.py``).

The sources are the reference's pretrained backbones (``src/mmbt.py:19,90``,
``train.py:166-169``): BERT (HF ``BertModel`` names, or the legacy
``pytorch_pretrained_bert`` ones: a ``bert.`` prefix, LayerNorm ``gamma`` /
``beta``), torchvision's ResNet-152, and HF ViLT (a
``ViltForImagesAndTextClassification`` dict, or a bare ``ViltModel`` one
without the ``vilt.`` prefix). No weight file is fetched: the caller passes
state dicts it has on disk (``torch.load(path, map_location="cpu",
weights_only=True)``).

Every tensor is written in place, ``copy_`` under ``torch.no_grad``, into the
model's existing parameters and buffers, cast to their dtype (fp32, also under
``--bf16``): an optimizer built over ``model.parameters()`` before or after the
import steps the imported values. What has no source keeps its random
initialisation: MMBT's classifier and image-embedding projection, ViLT's
classification head on a dict that has none (``dandelin/vilt-b32-mlm``).

Checks, each naming the key: a target the source does not give raises
``KeyError``; a source key that maps to no target raises ``KeyError``, except
the documented drops (torchvision's ``fc.*`` and ``num_batches_tracked``,
BERT's pre-training heads ``cls.*``, ViLT's ``mlm_score.*`` / ``itm_score.*``
/ ``mpp_score.*``, and ``position_ids`` buffers); a shape that differs from the
model's raises ``ValueError``.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

# MMBT: the BERT module tree (HF names) under the port's encoder
_BERT_PREFIXES = (("embeddings.", "enc.txt_embeddings."), ("encoder.", "enc.encoder."),
                  ("pooler.", "enc.pooler."))
_BERT_DROPS = re.compile(r"^cls\.|position_ids$")
_RESNET_PREFIX = "enc.img_encoder.model."
_RESNET_DROPS = re.compile(r"^fc\.|num_batches_tracked$")

# ViLT: HF names -> the port module's (``models/vilt.py``); ``{i}`` is the layer
_VILT_NAMES = {
    "vilt.embeddings.text_embeddings.word_embeddings.weight": "vilt.word_embeddings",
    "vilt.embeddings.text_embeddings.position_embeddings.weight": "vilt.position_embeddings",
    "vilt.embeddings.text_embeddings.token_type_embeddings.weight": "vilt.token_type_embeddings",
    "vilt.embeddings.text_embeddings.LayerNorm.weight": "vilt.emb_LayerNorm.weight",
    "vilt.embeddings.text_embeddings.LayerNorm.bias": "vilt.emb_LayerNorm.bias",
    "vilt.embeddings.token_type_embeddings.weight": "vilt.modality_type_embeddings",
    "vilt.embeddings.cls_token": "vilt.image_cls",
    "vilt.embeddings.position_embeddings": "vilt.image_position_embeddings",
    "vilt.embeddings.patch_embeddings.projection.weight": "vilt.patch_embed.weight",
    "vilt.embeddings.patch_embeddings.projection.bias": "vilt.patch_embed.bias",
    "vilt.layernorm.weight": "vilt.ln_post.weight",
    "vilt.layernorm.bias": "vilt.ln_post.bias",
    "vilt.pooler.dense.weight": "vilt.pooler.weight",
    "vilt.pooler.dense.bias": "vilt.pooler.bias",
    "classifier.0.weight": "cls_fc.weight",
    "classifier.0.bias": "cls_fc.bias",
    "classifier.1.weight": "cls_ln.weight",
    "classifier.1.bias": "cls_ln.bias",
    "classifier.3.weight": "cls_out.weight",
    "classifier.3.bias": "cls_out.bias",
}
_VILT_LAYER = re.compile(r"^vilt\.encoder\.layer\.(\d+)\.(.+)\.(weight|bias)$")
_VILT_BLOCK = {
    "attention.output.dense": "proj",
    "layernorm_before": "ln_1",
    "layernorm_after": "ln_2",
    "intermediate.dense": "fc1",
    "output.dense": "fc2",
}
_VILT_QKV = ("query", "key", "value")
_VILT_DROPS = re.compile(r"^(mlm_score|itm_score|mpp_score)\.|position_ids$")


def normalize_bert_keys(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The legacy ``pytorch_pretrained_bert`` names as HF's: the ``bert.``
    prefix stripped, LayerNorm ``gamma`` / ``beta`` as ``weight`` / ``bias``."""
    out = {}
    for k, v in sd.items():
        k = k[len("bert."):] if k.startswith("bert.") else k
        out[re.sub(r"\.gamma$", ".weight", re.sub(r"\.beta$", ".bias", k))] = v
    return out


def bert_targets(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A BERT state dict -> {MMBT target name: source tensor}. The embedding
    tables and their LayerNorm go once into the text embedding module, which
    both MMBT segments read."""
    out = {}
    for key, t in normalize_bert_keys(sd).items():
        if _BERT_DROPS.search(key):
            continue
        for src, dst in _BERT_PREFIXES:
            if key.startswith(src):
                out[dst + key[len(src):]] = t
                break
        else:
            raise KeyError(f"BERT weights: {key!r} maps to no parameter of MMBT")
    return out


def resnet_targets(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet state dict -> {MMBT target name: source tensor}
    (the headless trunk's names are torchvision's)."""
    return {_RESNET_PREFIX + k: t for k, t in sd.items() if not _RESNET_DROPS.search(k)}


def vilt_targets(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An HF ViLT state dict -> {ViLT target name: tensor}: each layer's
    query, key and value stacked by rows, q | k | v, into the packed ``qkv``;
    the image position table without its leading axis of 1."""
    if not any(k.startswith("vilt.") for k in sd):
        sd = {k if k.startswith("classifier.") else f"vilt.{k}": v for k, v in sd.items()}
    out, qkv = {}, {}
    for key, t in sd.items():
        if _VILT_DROPS.search(key):
            continue
        if key in _VILT_NAMES:
            name = _VILT_NAMES[key]
            out[name] = t[0] if name == "vilt.image_position_embeddings" and t.dim() == 3 else t
            continue
        m = _VILT_LAYER.match(key)
        part = m.group(2) if m else None
        if part in _VILT_BLOCK:
            out[f"vilt.block.{m.group(1)}.{_VILT_BLOCK[part]}.{m.group(3)}"] = t
        elif part is not None and part.startswith("attention.attention.") \
                and part.rsplit(".", 1)[1] in _VILT_QKV:
            qkv[(m.group(1), m.group(3), part.rsplit(".", 1)[1])] = (key, t)
        else:
            raise KeyError(f"ViLT weights: {key!r} maps to no parameter of ViLT")
    for layer, leaf in sorted({(i, leaf) for i, leaf, _ in qkv}):
        parts = []
        for which in _VILT_QKV:
            if (layer, leaf, which) not in qkv:
                raise KeyError(f"ViLT weights: vilt.encoder.layer.{layer}.attention.attention."
                               f"{which}.{leaf} missing (its layer's qkv is packed from all three)")
            parts.append(qkv[(layer, leaf, which)][1])
        out[f"vilt.block.{layer}.qkv.{leaf}"] = torch.cat(parts, dim=0)
    return out


def _copy_into(model: nn.Module, mapped: Dict[str, torch.Tensor], required, label: str) -> None:
    """Check ``mapped`` against the model (every required target given, no
    unknown one, equal shapes), then copy it into the model's own tensors."""
    own = model.state_dict()
    unknown = sorted(set(mapped) - set(own))
    if unknown:
        raise KeyError(f"{label} weights: {unknown[0]!r} is no parameter of the model "
                       f"({len(unknown)} such)")
    missing = sorted(k for k in own if required(k) and k not in mapped)
    if missing:
        raise KeyError(f"{label} weights: {missing[0]!r} missing from the state dict "
                       f"({len(missing)} targets missing)")
    for k, t in mapped.items():
        if tuple(t.shape) != tuple(own[k].shape):
            raise ValueError(f"{label} weights: {k}: pretrained shape {tuple(t.shape)} != model "
                             f"shape {tuple(own[k].shape)} (wrong config for this checkpoint?)")
    with torch.no_grad():
        for k, t in mapped.items():
            own[k].copy_(t.to(own[k].dtype))


def import_mmbt_pretrained(model: nn.Module, bert_sd: Optional[Mapping] = None,
                           resnet_sd: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """Copy pretrained BERT and / or torchvision ResNet weights into an MMBT
    (:class:`~multimodal_uncertainty_tpu_torch.models.mmbt.MultimodalBertClf`)
    in place: the BERT embeddings, encoder and pooler, and the ResNet trunk's
    convolutions, BatchNorm affines and running statistics. Returns
    {target name: source tensor}."""
    mapped: Dict[str, torch.Tensor] = {}
    prefixes: Tuple[str, ...] = ()
    if bert_sd is not None:
        mapped.update(bert_targets(bert_sd))
        prefixes += tuple(dst for _, dst in _BERT_PREFIXES)
    if resnet_sd is not None:
        mapped.update(resnet_targets(resnet_sd))
        prefixes += (_RESNET_PREFIX,)
    _copy_into(model, mapped,
               lambda k: k.startswith(prefixes) and not k.endswith("num_batches_tracked"),
               "MMBT")
    return mapped


def import_vilt_pretrained(model: nn.Module, sd: Mapping) -> Dict[str, torch.Tensor]:
    """Copy a pretrained HF ViLT state dict into the port's
    :class:`~multimodal_uncertainty_tpu_torch.models.vilt.
    ViltForImagesAndTextClassification` in place. The classification head is
    imported when the dict has one (all of it), and keeps its random
    initialisation otherwise. Returns {target name: tensor written}."""
    mapped = vilt_targets(sd)
    with_head = any(k.startswith("cls_") for k in mapped)
    _copy_into(model, mapped, lambda k: k.startswith("vilt.") or with_head, "ViLT")
    return mapped
