"""FLAVA-fusion modality-ablation robustness sweep (port of
``evals/robustness_transformer.py``).

Reference ``eval_transformer_robustness.py``: per batch, 3 + 2*n_repeats
forwards — full input, image-only, text-only, then ``n_repeats`` random
token-subset controls per modality (``input_sampling``, ``:37-52``: the
control keeps as many tokens as the ablated-modality forward would, drawn at
random across BOTH modalities). Output layout contract (consumed by the
notebooks): column 0 = full, 1 = image-only, 2 = text-only, 3..3+R =
image-controls, 3+R..3+2R = text-controls; tensor (S, V, E, C) in float32.

Every variant is a boolean keep-mask pair over the padded batch; the masked
forward equals physically dropping the tokens (see ``models/fusion.py``).
Where the JAX package vmaps chunks of 16 variants inside one jitted program,
the port stacks a chunk of variants onto the batch axis: one forward of
(chunk * B) rows, variant-major, each row with its own key mask, so each
variant is one row block of every attention launch. The masks come from
``np.random.default_rng(seed)`` exactly as the JAX package draws them, so the
two packages sweep the same variants.

Documented reference-bug fix kept from the JAX package: ``:119`` builds the
text control slice from ``img``; here text controls mask the text stream.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch


def input_sampling_masks(
    rng: np.random.Generator, l_img: int, l_txt: int, kind: str
) -> Tuple[np.ndarray, np.ndarray]:
    """One control variant: keep-mask pair with the reference's sampling law
    (n ~ U(0, l) inclusive; kept indices sorted-random without replacement).
    """
    assert kind in ("image", "text")
    l = l_img if kind == "image" else l_txt
    n = int(rng.integers(0, l + 1))
    n_img = n if kind == "image" else l - n
    n_txt = n if kind == "text" else l - n
    img_mask = np.zeros(l_img, bool)
    txt_mask = np.zeros(l_txt, bool)
    img_mask[rng.permutation(l_img)[:n_img]] = True
    txt_mask[rng.permutation(l_txt)[:n_txt]] = True
    return img_mask, txt_mask


def build_variant_masks(
    rng: np.random.Generator, l_img: int, l_txt: int, n_repeats: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(V, l_img), (V, l_txt) keep masks, V = 3 + 2*n_repeats, column
    contract as documented above."""
    img_masks = [np.ones(l_img, bool), np.ones(l_img, bool), np.zeros(l_img, bool)]
    txt_masks = [np.ones(l_txt, bool), np.zeros(l_txt, bool), np.ones(l_txt, bool)]
    for kind in ("image", "text"):
        for _ in range(n_repeats):
            im, tm = input_sampling_masks(rng, l_img, l_txt, kind)
            img_masks.append(im)
            txt_masks.append(tm)
    return np.stack(img_masks), np.stack(txt_masks)


def sweep_batch(model, img: torch.Tensor, txt: torch.Tensor, img_masks: torch.Tensor,
                txt_masks: torch.Tensor, variant_chunk: int = 16) -> torch.Tensor:
    """Logits of every variant of one batch: (B, L_i, D), (B, L_t, D) and the
    (V, L_i), (V, L_t) keep masks -> (B, V, E, C). Up to ``variant_chunk``
    variants go through one forward of (chunk * B) rows."""
    b = img.shape[0]
    outs = []
    for c0 in range(0, img_masks.shape[0], variant_chunk):
        im, tm = img_masks[c0:c0 + variant_chunk], txt_masks[c0:c0 + variant_chunk]
        ch = im.shape[0]
        out = model(
            (img.repeat(ch, 1, 1), txt.repeat(ch, 1, 1)),
            img_mask=im[:, None, :].expand(ch, b, im.shape[1]).reshape(ch * b, -1),
            txt_mask=tm[:, None, :].expand(ch, b, tm.shape[1]).reshape(ch * b, -1),
        )  # (ch * B, E, C), variant-major
        outs.append(out.reshape(ch, b, *out.shape[1:]))
    return torch.cat(outs).transpose(0, 1)


def transformer_robustness_sweep(
    model: torch.nn.Module,
    loader,
    *,
    n_repeats: int = 20,
    seed: int = 42,
    save_path: Optional[str] = None,
    checkpoint_name: str = "model",
    phase: str = "val",
    variant_chunk: int = 16,
):
    """Returns (preds (S, V, E, C) float32, labels (S,)); optionally saves
    ``robustness_{ckpt}_predictions_{phase}.npy`` (+labels).

    ``model`` is a :class:`~multimodal_uncertainty_tpu_torch.models.fusion.
    FlavaFusionTransformer`; the sweep runs in eval mode without gradients on
    the device its weights lie on. ``loader`` yields ``((img, txt), y)``
    numpy batches (``data/flava_encoded.py``)."""
    from multimodal_uncertainty_tpu_torch.evals.artifacts import concat_maybe_memmap

    rng = np.random.default_rng(seed)
    device = next(model.parameters()).device
    model.eval()
    preds, labels = [], []
    with torch.no_grad():
        for (img, txt), y in loader:
            l_img, l_txt = img.shape[1], txt.shape[1]
            # fresh random controls per batch, like the reference's in-loop sampling
            img_masks, txt_masks = build_variant_masks(rng, l_img, l_txt, n_repeats)
            out = sweep_batch(
                model, torch.from_numpy(np.asarray(img)).to(device),
                torch.from_numpy(np.asarray(txt)).to(device),
                torch.from_numpy(img_masks).to(device), torch.from_numpy(txt_masks).to(device),
                variant_chunk)
            preds.append(out.float().cpu().numpy())
            labels.append(np.asarray(y).reshape(-1))

    pred_path = (
        os.path.join(save_path, f"robustness_{checkpoint_name}_predictions_{phase}.npy")
        if save_path is not None
        else None
    )
    preds = concat_maybe_memmap(preds, axis=0, path=pred_path)
    labels = np.concatenate(labels, axis=0)
    if save_path is not None:
        os.makedirs(save_path, exist_ok=True)
        np.save(
            os.path.join(save_path, f"robustness_{checkpoint_name}_labels_{phase}.npy"),
            labels,
        )
    return preds, labels
