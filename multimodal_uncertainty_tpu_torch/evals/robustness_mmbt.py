"""MMBT modality-ablation robustness sweep (port of ``evals/robustness_mmbt.py``).

Reference ``eval_mmbt_robustness.py`` and the variant forwards of
``src/mmbt.py:130-234``: per batch, full, image-only and text-only, then
``n_repeats`` random token-subset controls per modality (``forward_control``:
keep [CLS] and n random positions of the concatenated sequence, n =
num_image_embeds + 1 for the image controls and txt_len for the text ones).
Output (S, 3 + 2 * n_repeats, C) float32, the columns as in the notebooks'
contract.

Every variant is a keep mask over the concatenated sequence that hides keys
only (``MultimodalBertEncoder.encode``). Where the JAX package vmaps chunks
of variants over one image, the port embeds each batch's images once
(ResNet, pooling, projection) and stacks a chunk of ``variant_chunk``
variants on the batch axis: one BERT pass of (chunk * B) rows, variant-major,
the image segment repeated across the chunk and each row with its own keep
mask. The masks come from ``np.random.default_rng(seed)`` exactly as the JAX
package draws them, so the two packages sweep the same variants.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from multimodal_uncertainty_tpu_torch.data.images import (
    FOOD101_MEAN,
    FOOD101_STD,
    normalize_on_device,
)


def build_mmbt_variant_masks(rng: np.random.Generator, txt_len: int, num_image_embeds: int,
                             n_repeats: int) -> np.ndarray:
    """(V, num_image_embeds + 2 + txt_len) keep masks, V = 3 + 2 * n_repeats."""
    n_img_tok = num_image_embeds + 2
    total = n_img_tok + txt_len
    masks = [
        np.ones(total, bool),  # full
        np.concatenate([np.ones(n_img_tok, bool), np.zeros(txt_len, bool)]),
        np.concatenate([np.ones(1, bool), np.zeros(n_img_tok - 1, bool), np.ones(txt_len, bool)]),
    ]
    for kind in ("image", "text"):
        n_keep = num_image_embeds + 1 if kind == "image" else txt_len
        for _ in range(n_repeats):
            m = np.zeros(total, bool)
            m[0] = True  # [CLS] always kept (reference :198)
            m[rng.permutation(total - 1)[:n_keep] + 1] = True
            masks.append(m)
    return np.stack(masks)


def sweep_mmbt_batch(model, x, keep_masks: torch.Tensor, variant_chunk: int = 8) -> torch.Tensor:
    """Logits of every variant of one batch: ``x`` = (token ids, text mask,
    token types, NHWC image) on the model's device and the (V, N + 2 + L)
    keep masks -> (B, V, C). The image is embedded once; up to
    ``variant_chunk`` variants go through one BERT pass of (chunk * B) rows."""
    txt, mask, segment, img = x
    if img.dtype == torch.uint8:
        img = normalize_on_device(img, FOOD101_MEAN, FOOD101_STD)
    enc = model.enc
    img_x = enc.embed_image(img)
    b = txt.shape[0]
    outs = []
    for c0 in range(0, keep_masks.shape[0], variant_chunk):
        keep = keep_masks[c0:c0 + variant_chunk]
        ch = keep.shape[0]
        pooled = enc.encode(img_x.repeat(ch, 1, 1), txt.repeat(ch, 1), mask.repeat(ch, 1),
                            segment.repeat(ch, 1),
                            keep[:, None, :].expand(ch, b, keep.shape[1]).reshape(ch * b, -1))
        outs.append(model.clf(pooled).reshape(ch, b, -1))  # variant-major rows
    return torch.cat(outs).transpose(0, 1)


def mmbt_robustness_sweep(
    model: torch.nn.Module,
    loader,
    *,
    num_image_embeds: int = 3,
    n_repeats: int = 20,
    seed: int = 42,
    save_path: Optional[str] = None,
    checkpoint_name: str = "model",
    phase: str = "val",
    variant_chunk: int = 8,
):
    """Returns (preds (S, V, C) float32, labels (S,)); with ``save_path``
    also writes ``robustness_{ckpt}_predictions_{phase}.npy`` and the labels.

    ``model`` is a :class:`~multimodal_uncertainty_tpu_torch.models.mmbt.
    MultimodalBertClf`; the sweep runs in eval mode without gradients on the
    device its weights lie on. ``loader`` yields ``((text, segment, mask,
    imgs), y)`` numpy batches (``data/food101.py``)."""
    from multimodal_uncertainty_tpu_torch.evals.artifacts import concat_maybe_memmap

    rng = np.random.default_rng(seed)
    device = next(model.parameters()).device
    model.eval()
    preds, labels = [], []
    with torch.no_grad():
        for x, y in loader:
            masks = build_mmbt_variant_masks(rng, x[0].shape[1], num_image_embeds, n_repeats)
            # the loader's (text, segment, mask, imgs), read as (txt, mask, segment, img) as the
            # train step reads it: segment and mask are equal (see ``data/food101.py``)
            x = tuple(torch.from_numpy(np.asarray(a)).to(device) for a in x)
            out = sweep_mmbt_batch(model, x, torch.from_numpy(masks).to(device), variant_chunk)
            preds.append(out.float().cpu().numpy())
            labels.append(np.asarray(y).reshape(-1))

    pred_path = (os.path.join(save_path, f"robustness_{checkpoint_name}_predictions_{phase}.npy")
                 if save_path is not None else None)
    preds = concat_maybe_memmap(preds, axis=0, path=pred_path)
    labels = np.concatenate(labels, axis=0)
    if save_path is not None:
        os.makedirs(save_path, exist_ok=True)
        np.save(os.path.join(save_path, f"robustness_{checkpoint_name}_labels_{phase}.npy"),
                labels)
    return preds, labels
