"""Serving: checkpoint -> batched predictor -> micro-batcher (port of ``serving.py``).

Three model families: FLAVA fusion (:class:`FusionPredictor`), MMBT
(:class:`MMBTPredictor`) and ViLT (:class:`ViltPredictor`).

* one forward per padded shape bucket: batch sizes round up to a bucket and
  sequence lengths to ``pad_multiple``, so the shapes the card sees stay few;
* ensemble-mean probabilities, each head tempered before the mean;
* modality ablation through the masked forward (the uncertainty probes);
* ``quantize="int8" | "int8_weight"``: every ``Linear`` runs int8
  (``ops/quant.py``; :func:`~multimodal_uncertainty_tpu_torch.models.layers.set_quantize`).

Each predictor's forward is a module, :class:`FusionProbs`, :class:`MMBTProbs`
or :class:`ViltProbs`: the model, the temperature and the softmax, on tensors.
``export.py`` exports the same module, so an artifact computes what the live
predictor does.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_uncertainty_tpu_torch.batching import (  # noqa: F401 (the serving API)
    MicroBatcher,
    Overloaded,
    _bucket_for,
    _round_up,
)
from multimodal_uncertainty_tpu_torch.device import resolve_device
from multimodal_uncertainty_tpu_torch.models.layers import set_quantize
from multimodal_uncertainty_tpu_torch.training.checkpoint import load_weights, restore_into


class FusionProbs(torch.nn.Module):
    """FLAVA fusion's served function: (img, txt, img_mask, txt_mask) ->
    ensemble-mean probabilities (B, C), each head's logits divided by
    ``temperature`` before its softmax (a proper distribution per member)."""

    def __init__(self, model: torch.nn.Module, temperature: float = 1.0):
        super().__init__()
        self.model, self.temperature = model, float(temperature)

    def forward(self, img, txt, img_mask, txt_mask) -> torch.Tensor:
        logits = self.model((img, txt), img_mask=img_mask, txt_mask=txt_mask)
        return torch.softmax(logits.float() / self.temperature, dim=-1).mean(dim=1)


class MMBTProbs(torch.nn.Module):
    """MMBT's served function: (txt ids, text mask, segment, NHWC image[,
    keep mask over the image + text sequence]) -> probabilities (B, C)."""

    def __init__(self, model: torch.nn.Module, temperature: float = 1.0):
        super().__init__()
        self.model, self.temperature = model, float(temperature)

    def forward(self, txt, mask, segment, img, keep=None) -> torch.Tensor:
        logits = self.model((txt, mask, segment, img), seq_keep_mask=keep)
        return torch.softmax(logits.float() / self.temperature, dim=-1)


class ViltProbs(torch.nn.Module):
    """ViLT's served function: (input_ids, attention_mask, token_type_ids or
    None, pixel_values, pixel_mask) -> probabilities (B, C)."""

    def __init__(self, model: torch.nn.Module, temperature: float = 1.0):
        super().__init__()
        self.model, self.temperature = model, float(temperature)

    def forward(self, input_ids, attention_mask, token_type_ids, pixel_values,
                pixel_mask) -> torch.Tensor:
        batch = {"input_ids": input_ids, "attention_mask": attention_mask,
                 "pixel_values": pixel_values, "pixel_mask": pixel_mask}
        if token_type_ids is not None:
            batch["token_type_ids"] = token_type_ids
        logits = self.model(batch).logits
        return torch.softmax(logits.float() / self.temperature, dim=-1)


def _restored(model: torch.nn.Module, checkpoint_path: str, device: torch.device,
              quantize: Optional[str]) -> torch.nn.Module:
    """The checkpoint's weights in ``model`` (strictly), on ``device``, in
    eval mode, its Linears quantized under ``quantize``."""
    model_sd, _ = load_weights(checkpoint_path)
    model = restore_into(model, model_sd).to(device).eval()
    set_quantize(model, quantize)
    return model


class FusionPredictor:
    """Batched predictor over a FlavaFusionTransformer checkpoint.

    ``model`` is the architecture the checkpoint was saved from (for example
    :func:`~multimodal_uncertainty_tpu_torch.zoo.build_flava`); its weights
    are replaced by the checkpoint's, strictly. Runs on ``device``, default
    ``cuda``; ``quantize`` as the module says."""

    def __init__(
        self,
        model: torch.nn.Module,
        checkpoint_path: str,
        *,
        pad_multiple: int = 32,
        batch_buckets: Sequence[int] = (8, 32, 128),
        quantize: Optional[str] = None,
        temperature: float = 1.0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = _restored(model, checkpoint_path, self.device, quantize)
        self.pad_multiple = pad_multiple
        self.batch_buckets = sorted(batch_buckets)
        self.quantize = quantize
        self.temperature = float(temperature)
        self.probs = FusionProbs(self.model, self.temperature)

    @torch.inference_mode()
    def _forward(self, img, txt, img_mask, txt_mask) -> torch.Tensor:
        return self.probs(img, txt, img_mask, txt_mask)

    def predict(
        self,
        img: np.ndarray,
        txt: np.ndarray,
        *,
        img_lengths: Optional[np.ndarray] = None,
        txt_lengths: Optional[np.ndarray] = None,
        ablate: Optional[str] = None,  # None | 'image' | 'text'
    ) -> np.ndarray:
        """(N, L_i, D), (N, L_t, D) -> (N, C) ensemble-mean probabilities.

        Lengths (if given) mask padding; ``ablate`` drops a modality through
        the masked forward. Padded batch rows have every key masked."""
        if ablate not in (None, "image", "text"):
            raise ValueError(f"ablate must be None, 'image' or 'text', got {ablate!r}")
        n = img.shape[0]
        nb = _bucket_for(n, self.batch_buckets)
        li = _round_up(img.shape[1], self.pad_multiple)
        lt = _round_up(txt.shape[1], self.pad_multiple)

        img_p = np.zeros((nb, li, img.shape[2]), np.float32)
        txt_p = np.zeros((nb, lt, txt.shape[2]), np.float32)
        img_p[:n, : img.shape[1]] = img
        txt_p[:n, : txt.shape[1]] = txt

        im_full = np.zeros((nb, li), bool)
        tm_full = np.zeros((nb, lt), bool)
        il = img_lengths if img_lengths is not None else np.full(n, img.shape[1])
        tl = txt_lengths if txt_lengths is not None else np.full(n, txt.shape[1])
        im_full[:n] = np.arange(li)[None, :] < np.asarray(il)[:, None]
        tm_full[:n] = np.arange(lt)[None, :] < np.asarray(tl)[:, None]
        if ablate == "image":
            im_full[:] = False
        elif ablate == "text":
            tm_full[:] = False

        dev = self.device
        probs = self._forward(
            torch.from_numpy(img_p).to(dev),
            torch.from_numpy(txt_p).to(dev),
            torch.from_numpy(im_full).to(dev),
            torch.from_numpy(tm_full).to(dev),
        )
        return probs.cpu().numpy()[:n]

    def predict_with_uncertainty(
        self, img: np.ndarray, txt: np.ndarray, **kw
    ) -> Tuple[np.ndarray, dict]:
        """Probabilities + modality-sensitivity diagnostics (|dp| against
        image-only / text-only ablations)."""
        if "ablate" in kw:
            raise ValueError(
                "predict_with_uncertainty computes its own ablations; "
                "pass ablate= to predict() instead"
            )
        full = self.predict(img, txt, **kw)
        img_only = self.predict(img, txt, ablate="text", **kw)
        txt_only = self.predict(img, txt, ablate="image", **kw)
        return full, {
            "confidence": full.max(-1),
            "image_sensitivity": np.abs(full - txt_only).max(-1),
            "text_sensitivity": np.abs(full - img_only).max(-1),
        }


def _padded_on(a: np.ndarray, rows: int, device: torch.device) -> torch.Tensor:
    """``a`` copied to ``device`` with zero rows appended up to ``rows``; the
    padding is made on the device, not in a host buffer."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if rows == a.shape[0]:
        return t
    return torch.cat([t, t.new_zeros((rows - a.shape[0],) + tuple(a.shape[1:]))])


class MMBTPredictor:
    """Batched predictor over an MMBT (BERT + ResNet) checkpoint.

    Inputs: tokenised text (ids, mask, segment) and images as they come (no
    normalisation, as the JAX predictor calls the model directly). ``model``
    is the architecture the checkpoint was saved from (for example
    :func:`~multimodal_uncertainty_tpu_torch.zoo.build_mmbt`); its weights
    and BatchNorm statistics are replaced by the checkpoint's, strictly.
    Modality ablation is the encoder's keep masks, one extra forward each.
    Runs on ``device``, default ``cuda``; ``quantize`` as the module says."""

    def __init__(
        self,
        model: torch.nn.Module,
        checkpoint_path: str,
        *,
        batch_buckets: Sequence[int] = (8, 32),
        quantize: Optional[str] = None,
        temperature: float = 1.0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = _restored(model, checkpoint_path, self.device, quantize)
        self.batch_buckets = sorted(batch_buckets)
        self.quantize = quantize
        self.temperature = float(temperature)
        self.probs = MMBTProbs(self.model, self.temperature)

    @torch.inference_mode()
    def _forward(self, x, keep) -> torch.Tensor:
        return self.probs(*x, keep)

    def predict(self, txt, mask, segment, img, *, ablate: Optional[str] = None) -> np.ndarray:
        """(N, L) ids / mask / segment + (N, H, W, 3) images -> (N, C) probs.

        Rows added to reach the batch bucket have text mask 0 (their image
        segment stays, so no row is fully masked). ``ablate="text"`` keeps
        the image segment only, ``"image"`` its [CLS] and the text."""
        if ablate not in (None, "image", "text"):
            raise ValueError(f"ablate must be None, 'image' or 'text', got {ablate!r}")
        n, lt = txt.shape
        nb = _bucket_for(n, self.batch_buckets)
        dev = self.device
        x = (_padded_on(np.asarray(txt, np.int64), nb, dev),
             _padded_on(np.asarray(mask, np.int64), nb, dev),
             _padded_on(np.asarray(segment, np.int64), nb, dev),
             _padded_on(np.asarray(img), nb, dev))
        keep = None
        if ablate == "text":
            keep = self.model.enc.img_only_mask(nb, lt, dev)
        elif ablate == "image":
            keep = self.model.enc.txt_only_mask(nb, lt, dev)
        probs = self._forward(x, keep)
        return probs.cpu().numpy()[:n]

    def predict_with_uncertainty(self, txt, mask, segment, img) -> Tuple[np.ndarray, dict]:
        """Probabilities + modality-sensitivity diagnostics (|dp| against
        image-only / text-only ablations): three forwards."""
        full = self.predict(txt, mask, segment, img)
        img_only = self.predict(txt, mask, segment, img, ablate="text")
        txt_only = self.predict(txt, mask, segment, img, ablate="image")
        return full, {
            "confidence": full.max(-1),
            "image_sensitivity": np.abs(full - txt_only).max(-1),
            "text_sensitivity": np.abs(full - img_only).max(-1),
        }


class ViltPredictor:
    """Batched predictor over a ViLT checkpoint (port of ``serving.py::
    ViltPredictor``, :210-286): processor batch dicts in, class
    probabilities out.

    Pixels are fed as they come, unnormalised, as the JAX predictor calls the
    model directly; a batch without a ``pixel_mask`` gets ones, so the model
    always takes its position-interpolation branch. Modality ablation is the
    masks: ``ablate="text"`` keeps only the text's [CLS], ``"image"`` drops
    every patch (the image [CLS] stays). ``model`` is the architecture the
    checkpoint was saved from (for example
    :func:`~multimodal_uncertainty_tpu_torch.zoo.build_vilt`); its weights
    are replaced by the checkpoint's, strictly. Runs on ``device``, default
    ``cuda``; ``quantize`` as the module says."""

    def __init__(
        self,
        model: torch.nn.Module,
        checkpoint_path: str,
        *,
        batch_buckets: Sequence[int] = (8, 32),
        quantize: Optional[str] = None,
        temperature: float = 1.0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = _restored(model, checkpoint_path, self.device, quantize)
        self.batch_buckets = sorted(batch_buckets)
        self.quantize = quantize
        self.temperature = float(temperature)
        self.max_text_len = self.model.config.max_position_embeddings
        self.probs = ViltProbs(self.model, self.temperature)

    @torch.inference_mode()
    def _forward(self, batch: dict) -> torch.Tensor:
        return self.probs(batch["input_ids"], batch["attention_mask"],
                          batch.get("token_type_ids"), batch["pixel_values"],
                          batch["pixel_mask"])

    def predict(self, batch: dict, *, ablate: Optional[str] = None) -> np.ndarray:
        """A processor batch dict (``input_ids`` / ``attention_mask`` /
        ``token_type_ids`` (N, L), ``pixel_values`` (N, H, W, 3) or (N, 3, H,
        W), optional ``pixel_mask`` (N, H, W)) -> (N, C) probabilities. Rows
        added to reach the batch bucket are zeros."""
        if ablate not in (None, "image", "text"):
            raise ValueError(f"ablate must be None, 'image' or 'text', got {ablate!r}")
        n = batch["input_ids"].shape[0]
        nb = _bucket_for(n, self.batch_buckets)
        b = {k: np.asarray(v) for k, v in batch.items() if v is not None and k != "labels"}
        if "pixel_mask" in b:
            # the model keeps a patch where any pixel is > 0: one byte a pixel says as much
            b["pixel_mask"] = (b["pixel_mask"] > 0).astype(np.uint8)
        if ablate == "text":  # keep only the text [CLS]
            am = np.zeros_like(b["attention_mask"])
            am[:, 0] = 1
            b["attention_mask"] = am
        x = {k: _padded_on(v, nb, self.device) for k, v in b.items()}
        if "pixel_mask" not in x:
            pv = b["pixel_values"]
            hw = pv.shape[-2:] if pv.shape[1] in (1, 3) else pv.shape[1:3]
            x["pixel_mask"] = torch.ones((nb,) + tuple(hw), dtype=torch.uint8, device=self.device)
        if ablate == "image":  # drop every patch; the image [CLS] stays
            x["pixel_mask"] = torch.zeros_like(x["pixel_mask"])
        return self._forward(x).cpu().numpy()[:n]

    def predict_with_uncertainty(self, batch: dict) -> Tuple[np.ndarray, dict]:
        """Probabilities + modality-sensitivity diagnostics (|dp| against
        image-only / text-only ablations): three forwards."""
        full = self.predict(batch)
        img_only = self.predict(batch, ablate="text")
        txt_only = self.predict(batch, ablate="image")
        return full, {
            "confidence": full.max(-1),
            "image_sensitivity": np.abs(full - txt_only).max(-1),
            "text_sensitivity": np.abs(full - img_only).max(-1),
        }


def fusion_micro_batcher(predictor: FusionPredictor, *, max_batch: int = 32,
                         max_wait_ms: float = 5.0, max_pending=None,
                         uncertainty: bool = False) -> MicroBatcher:
    """MicroBatcher over a FusionPredictor for variable-length samples.

    Each sample is ``(img, txt)`` with shapes (L_i, D)/(L_t, D); the batch
    call pads to the longest sample of the coalesced batch and passes the
    true lengths so padding is masked. With ``uncertainty=True`` each result
    is ``(probs, {confidence, image_sensitivity, text_sensitivity})`` (three
    masked forwards per coalesced batch, not per caller)."""

    def predict_batch(samples):
        n = len(samples)
        li = max(s[0].shape[0] for s in samples)
        lt = max(s[1].shape[0] for s in samples)
        d_img = samples[0][0].shape[-1]
        d_txt = samples[0][1].shape[-1]  # may differ (text_hidden_size)
        img = np.zeros((n, li, d_img), np.float32)
        txt = np.zeros((n, lt, d_txt), np.float32)
        il = np.zeros(n, np.int32)
        tl = np.zeros(n, np.int32)
        for i, (im, tx) in enumerate(samples):
            img[i, : im.shape[0]] = im
            txt[i, : tx.shape[0]] = tx
            il[i], tl[i] = im.shape[0], tx.shape[0]
        if uncertainty:
            probs, diag = predictor.predict_with_uncertainty(
                img, txt, img_lengths=il, txt_lengths=tl
            )
            return [
                (probs[i], {k: v[i] for k, v in diag.items()})
                for i in range(n)
            ]
        probs = predictor.predict(img, txt, img_lengths=il, txt_lengths=tl)
        return list(probs)

    return MicroBatcher(predict_batch, max_batch=max_batch,
                        max_wait_ms=max_wait_ms, max_pending=max_pending)


def mmbt_micro_batcher(predictor: MMBTPredictor, *, max_batch: int = 32,
                       max_wait_ms: float = 5.0, max_pending=None, pad_multiple: int = 32,
                       uncertainty: bool = False) -> MicroBatcher:
    """MicroBatcher over an MMBTPredictor. Each sample is ``(token_ids,
    segment, image)``: variable-length text and an (H, W, 3) image. The text
    pads to the coalesced batch's longest, rounded up to ``pad_multiple``;
    the mask marks real tokens. With ``uncertainty=True`` each result is
    ``(probs, {confidence, image_sensitivity, text_sensitivity})`` (three
    forwards per coalesced batch)."""

    def predict_batch(samples):
        n = len(samples)
        lt = _round_up(max(len(s[0]) for s in samples), pad_multiple)
        txt = np.zeros((n, lt), np.int64)
        seg = np.zeros((n, lt), np.int64)
        mask = np.zeros((n, lt), np.int64)
        img = np.stack([s[2] for s in samples])
        for i, (ids, segment, _) in enumerate(samples):
            txt[i, : len(ids)] = ids
            seg[i, : len(ids)] = segment
            mask[i, : len(ids)] = 1
        if uncertainty:
            probs, diag = predictor.predict_with_uncertainty(txt, mask, seg, img)
            return [(probs[i], {k: v[i] for k, v in diag.items()}) for i in range(n)]
        return list(predictor.predict(txt, mask, seg, img))

    return MicroBatcher(predict_batch, max_batch=max_batch,
                        max_wait_ms=max_wait_ms, max_pending=max_pending)


def vilt_micro_batcher(predictor: ViltPredictor, *, max_batch: int = 32,
                       max_wait_ms: float = 5.0, max_pending=None, pad_multiple: int = 8,
                       uncertainty: bool = False) -> MicroBatcher:
    """MicroBatcher over a ViltPredictor. Each sample is a processor dict
    (``input_ids`` and, where given, ``attention_mask`` / ``token_type_ids``
    of length L, ``pixel_values`` (H, W, 3), optional ``pixel_mask`` (H,
    W)); text keys a sample lacks are zeros. The text pads to the coalesced
    batch's longest, rounded up to ``pad_multiple``. In a batch where some
    samples bring a pixel mask, the others get ones: a result never depends
    on its batch companions. With ``uncertainty=True`` each result is
    ``(probs, {confidence, image_sensitivity, text_sensitivity})`` (three
    forwards per coalesced batch)."""

    text_keys = ("input_ids", "attention_mask", "token_type_ids")

    def predict_batch(samples):
        n = len(samples)
        lt = _round_up(max(len(s["input_ids"]) for s in samples), pad_multiple)
        batch = {}
        for k in text_keys:
            rows = np.zeros((n, lt), np.int64)
            for i, s in enumerate(samples):
                if k in s:
                    rows[i, : len(s[k])] = s[k]
            batch[k] = rows
        batch["pixel_values"] = np.stack([np.asarray(s["pixel_values"]) for s in samples])
        if any("pixel_mask" in s for s in samples):
            hw = batch["pixel_values"].shape[1:3]
            batch["pixel_mask"] = np.stack([
                np.asarray(s["pixel_mask"]) if "pixel_mask" in s else np.ones(hw, np.int64)
                for s in samples])
        if uncertainty:
            probs, diag = predictor.predict_with_uncertainty(batch)
            return [(probs[i], {k: v[i] for k, v in diag.items()}) for i in range(n)]
        return list(predictor.predict(batch))

    return MicroBatcher(predict_batch, max_batch=max_batch,
                        max_wait_ms=max_wait_ms, max_pending=max_pending)
