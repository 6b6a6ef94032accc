"""Serving: checkpoint -> batched predictor -> micro-batcher (port of ``serving.py``).

Three model families: FLAVA fusion (:class:`FusionPredictor`), MMBT
(:class:`MMBTPredictor`) and ViLT (:class:`ViltPredictor`).

* one forward per padded shape bucket: batch sizes round up to a bucket and
  sequence lengths to ``pad_multiple``, so the shapes the card sees stay few;
* ensemble-mean probabilities, each head tempered before the mean;
* modality ablation through the masked forward (the uncertainty probes).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_uncertainty_tpu_torch.device import resolve_device
from multimodal_uncertainty_tpu_torch.training.checkpoint import load_weights, restore_into


class Overloaded(RuntimeError):
    """Raised by :meth:`MicroBatcher.submit` when the admission queue is
    full (``max_pending``); maps to HTTP 503 in the serving endpoint."""


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket holding ``n``; past the largest bucket, ``n`` rounded up
    to a multiple of it."""
    for b in buckets:
        if n <= b:
            return b
    return _round_up(n, buckets[-1])


class FusionPredictor:
    """Batched predictor over a FlavaFusionTransformer checkpoint.

    ``model`` is the architecture the checkpoint was saved from (for example
    :func:`~multimodal_uncertainty_tpu_torch.zoo.build_flava`); its weights
    are replaced by the checkpoint's, strictly. Runs on ``device``, default
    ``cuda``."""

    def __init__(
        self,
        model: torch.nn.Module,
        checkpoint_path: str,
        *,
        pad_multiple: int = 32,
        batch_buckets: Sequence[int] = (8, 32, 128),
        temperature: float = 1.0,
        device=None,
    ):
        self.device = resolve_device(device)
        model_sd, _ = load_weights(checkpoint_path)
        self.model = restore_into(model, model_sd).to(self.device).eval()
        self.pad_multiple = pad_multiple
        self.batch_buckets = sorted(batch_buckets)
        self.temperature = float(temperature)

    @torch.inference_mode()
    def _forward(self, img, txt, img_mask, txt_mask) -> torch.Tensor:
        logits = self.model((img, txt), img_mask=img_mask, txt_mask=txt_mask)
        # per-head tempering BEFORE the head average keeps every member a
        # proper distribution
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return probs.mean(dim=1)  # ensemble mean over heads

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
    Runs on ``device``, default ``cuda``."""

    def __init__(
        self,
        model: torch.nn.Module,
        checkpoint_path: str,
        *,
        batch_buckets: Sequence[int] = (8, 32),
        temperature: float = 1.0,
        device=None,
    ):
        self.device = resolve_device(device)
        model_sd, _ = load_weights(checkpoint_path)
        self.model = restore_into(model, model_sd).to(self.device).eval()
        self.batch_buckets = sorted(batch_buckets)
        self.temperature = float(temperature)

    @torch.inference_mode()
    def _forward(self, x, keep) -> torch.Tensor:
        logits = self.model(x, seq_keep_mask=keep)
        return torch.softmax(logits.float() / self.temperature, dim=-1)

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
    ``cuda``."""

    def __init__(
        self,
        model: torch.nn.Module,
        checkpoint_path: str,
        *,
        batch_buckets: Sequence[int] = (8, 32),
        temperature: float = 1.0,
        device=None,
    ):
        self.device = resolve_device(device)
        model_sd, _ = load_weights(checkpoint_path)
        self.model = restore_into(model, model_sd).to(self.device).eval()
        self.batch_buckets = sorted(batch_buckets)
        self.temperature = float(temperature)
        self.max_text_len = self.model.config.max_position_embeddings

    @torch.inference_mode()
    def _forward(self, batch: dict) -> torch.Tensor:
        logits = self.model(batch).logits
        return torch.softmax(logits.float() / self.temperature, dim=-1)

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


# ---------------------------------------------------------------------------
# Dynamic micro-batching (serving runtime)
# ---------------------------------------------------------------------------


class MicroBatcher:
    """Dynamic request batching in front of a predictor.

    Concurrent callers submit single samples; a collector thread coalesces
    them into one batched ``predict_batch`` call (up to ``max_batch`` samples,
    waiting at most ``max_wait_ms`` after the first arrival), then hands each
    caller's future its result.

    ``predict_batch``: ``list[sample] -> sequence[result]`` (one result per
    sample, same order). Exceptions fail every request in that batch.
    """

    _CLOSE = object()  # queue sentinel: no submit/close race, no idle polling

    def __init__(self, predict_batch, *, max_batch: int = 32,
                 max_wait_ms: float = 5.0, max_pending: Optional[int] = None):
        import queue as _queue
        import threading as _threading

        self.predict_batch = predict_batch
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        # backpressure: a bounded admission queue sheds load at the door
        # (Overloaded -> HTTP 503). None = unbounded.
        self.max_pending = max_pending
        self._q: "_queue.Queue" = _queue.Queue()
        self._pending = 0
        self._closed = _threading.Event()
        self._submit_lock = _threading.Lock()
        self._thread = _threading.Thread(target=self._collect, daemon=True)
        self._thread.start()

    def submit(self, sample):
        """Enqueue one sample; returns a concurrent.futures.Future. Raises
        :class:`Overloaded` when ``max_pending`` requests are already queued."""
        from concurrent.futures import Future

        fut: Future = Future()
        # atomic closed-check + enqueue: every accepted request lands BEFORE
        # close()'s sentinel, so none is orphaned
        with self._submit_lock:
            if self._closed.is_set():
                raise RuntimeError("MicroBatcher is closed")
            if (self.max_pending is not None
                    and self._pending >= self.max_pending):
                raise Overloaded(
                    f"{self._pending} requests pending (max_pending="
                    f"{self.max_pending})"
                )
            self._pending += 1
            self._q.put((sample, fut))
        return fut

    def __call__(self, sample):
        return self.submit(sample).result()

    def close(self):
        """Stop the collector; requests accepted before close are still served
        (the sentinel travels the queue behind them)."""
        with self._submit_lock:
            already = self._closed.is_set()
            self._closed.set()
            if not already:
                self._q.put(self._CLOSE)
        self._thread.join()

    # -- collector ---------------------------------------------------------
    def _drain_remaining(self):
        """Serve requests that landed behind the sentinel, then exit."""
        import queue as _queue

        while True:
            batch = []
            while len(batch) < self.max_batch:
                try:
                    item = self._q.get_nowait()
                except _queue.Empty:
                    break
                if item is not self._CLOSE:
                    batch.append(item)
            if not batch:
                return
            self._serve(batch)

    def _serve(self, batch):
        # these items left the admission queue: free their pending slots
        with self._submit_lock:
            self._pending -= len(batch)
        # claim the futures: cancelled ones drop out, live ones can no longer
        # be cancelled mid-flight
        samples, futures = [], []
        for s, f in batch:
            if f.set_running_or_notify_cancel():
                samples.append(s)
                futures.append(f)
        if not samples:
            return
        try:
            results = self.predict_batch(samples)
            if len(results) != len(samples):
                raise ValueError(
                    f"predict_batch returned {len(results)} results "
                    f"for {len(samples)} samples"
                )
        except BaseException as e:  # handed to every caller's future
            for f in futures:
                f.set_exception(e)
        else:
            for f, r in zip(futures, results):
                f.set_result(r)

    def _collect(self):
        import queue as _queue
        import time as _time

        while True:
            first = self._q.get()
            if first is self._CLOSE:
                self._drain_remaining()
                return
            batch = [first]
            deadline = _time.monotonic() + self.max_wait_s
            saw_close = False
            while len(batch) < self.max_batch:
                timeout = deadline - _time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = self._q.get(timeout=timeout)
                except _queue.Empty:
                    break
                if item is self._CLOSE:
                    saw_close = True
                    break
                batch.append(item)
            self._serve(batch)
            if saw_close:
                self._drain_remaining()
                return


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
