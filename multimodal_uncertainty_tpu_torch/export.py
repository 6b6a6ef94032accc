"""Model-code-free serving artifacts on ``torch.export`` (port of ``export.py``).

A deployment wants an artifact that a process loads and serves without the
model classes: no ``models/``, no ``zoo``, no predictors. ``torch.export``
traces a predictor's served function (``serving.FusionProbs``, ``MMBTProbs``,
``ViltProbs``: the model, the temperature, the softmax) into an FX graph of
operators with its weights, and this module packages it as a directory::

    artifact/
      program.pt2   torch.export.save: the graph, its weights and constants
      meta.json     inputs, family, baked settings, sha256 of program.pt2

Loading (:func:`load_exported`) imports only torch, numpy and the port's
``ops`` modules that register the operators the graph calls: the attention
forward (``torch.ops.mmu.attention_fwd``, ``ops/attention.py``), the LayerNorm
kernel (``torch.ops.mmu.layer_norm``, ``ops/norms.py``) and the int8 product
(``torch.ops.mmu.int8_mm``, ``ops/quant.py``).

Where the JAX package's symbolic-batch artifacts run XLA's attention (its
Pallas grids need concrete blocks), the port's keep the hand-written attention
kernels in every artifact: the operator's fake version gives shapes alone, so
the batch (and FLAVA's lengths) stay symbolic, and at run time it dispatches
on the tensor's device, the kernel on the card, the plain version on the CPU.
``meta.json`` says so (``"kernels": true``).

* **Symbolic batch** (the default): one program for every batch size
  (``torch.export.Dim``). The artifact micro-batchers below still pad a
  coalesced batch to the live predictors' buckets, so the shapes the card sees
  stay the same few. ``fixed_batch`` bakes one batch size instead.
* **Symbolic lengths** (FLAVA): the image and text lengths are dims too,
  declared as multiples of the padding (``32 * Dim``).
* **Devices**: the program is written on the device of the predictor it was
  exported from and moved on load (``move_to_device_pass``), so an artifact
  written on the CPU serves on the card.
* **Baked settings**: the temperature and the int8 mode (its quantized weights
  are constants of the program), and MMBT's ``with_ablations`` keep-mask input.
"""
from __future__ import annotations

import hashlib
import json
import os
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

# the operators an exported program calls, registered on import
from multimodal_uncertainty_tpu_torch.ops import attention as _attention  # noqa: F401
from multimodal_uncertainty_tpu_torch.ops import norms as _norms  # noqa: F401
from multimodal_uncertainty_tpu_torch.ops import quant as _quant  # noqa: F401
from multimodal_uncertainty_tpu_torch.batching import MicroBatcher, _bucket_for, _round_up
from multimodal_uncertainty_tpu_torch.device import resolve_device

PROGRAM_FILE = "program.pt2"
META_FILE = "meta.json"
# the example batch an export traces with: torch.export specialises a dim whose example is 0 or 1,
# and guards a symbolic batch to [2, 65535] on the card (the CUDA grid's y limit); a program call
# of one row pads it to MIN_BATCH (``ExportedPredictor``)
_EXAMPLE_BATCH = MIN_BATCH = 2
_MAX_BATCH = 65535
_MAX_LEN_BLOCKS = 1 << 10


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def save_exported(path: str, module: torch.nn.Module, example_inputs: Sequence[torch.Tensor],
                  *, dynamic_shapes=None, meta: Optional[dict] = None) -> None:
    """Export ``module(*example_inputs)`` and write the directory artifact.

    ``dynamic_shapes`` is ``torch.export``'s (one dict of dim -> ``Dim`` an
    input, or None), e.g. :func:`symbolic_batch_specs`. Non-strict tracing:
    the models' Python runs as it is."""
    module.eval()
    ep = torch.export.export(module, tuple(example_inputs), dynamic_shapes=dynamic_shapes,
                             strict=False)
    os.makedirs(path, exist_ok=True)
    program = os.path.join(path, PROGRAM_FILE)
    torch.export.save(ep, program)
    shapes = [n.meta["val"] for n in ep.graph.nodes
              if n.op == "placeholder" and n.name in ep.graph_signature.user_inputs]
    record = {
        "torch_version": torch.__version__,
        "exported_on": str(example_inputs[0].device),
        "platforms": ["cpu", "cuda"],
        "kernels": True,
        "tpu_kernels": False,
        "inputs": [{"shape": [str(d) for d in v.shape], "dtype": str(v.dtype)} for v in shapes],
        # integrity: a corrupt or mixed-up program fails on load, not while serving
        "sha256": {PROGRAM_FILE: _sha256(program)},
        **(meta or {}),
    }
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(record, f, indent=2)


def symbolic_batch_specs(example_inputs: Sequence[torch.Tensor]) -> tuple:
    """``dynamic_shapes`` giving every input one shared symbolic leading dim:
    one exported program for every batch size."""
    b = torch.export.Dim("b", min=MIN_BATCH, max=_MAX_BATCH)
    return tuple({0: b} for _ in example_inputs)


class ExportedPredictor:
    """A loaded artifact: ``__call__(*numpy inputs) -> np.ndarray``, the
    program run on ``device`` under inference mode. Touches no model code. A
    symbolic-batch program takes at least ``MIN_BATCH`` rows: fewer are
    padded with zero rows, and their outputs dropped."""

    def __init__(self, program: "torch.export.ExportedProgram", meta: dict, device: torch.device):
        self.module = program.module()
        self.meta = meta
        self.device = device

    @torch.inference_mode()
    def __call__(self, *inputs) -> np.ndarray:
        n = len(inputs[0])
        if self.meta.get("fixed_batch") is None and n < MIN_BATCH:
            inputs = [np.concatenate([a, np.zeros((MIN_BATCH - n,) + a.shape[1:], a.dtype)])
                      for a in inputs]
        out = self.module(*(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                            for a in inputs))
        return out.cpu().numpy()[:n]


def load_exported(path: str, *, verify: bool = True, device=None) -> ExportedPredictor:
    """Load an artifact onto ``device`` (default ``cuda``; ``"cpu"`` runs the
    plain versions). ``verify=True`` checks the sha256 that ``meta.json``
    records for ``program.pt2`` before anything is deserialised: a corrupt
    or swapped program fails here instead of serving."""
    dev = resolve_device(device)
    program = os.path.join(path, PROGRAM_FILE)
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    if verify:
        want = meta.get("sha256", {}).get(PROGRAM_FILE)
        got = _sha256(program)
        if got != want:
            raise ValueError(f"artifact integrity check failed for {PROGRAM_FILE}: sha256 {got} "
                             f"!= recorded {want} (pass verify=False to load anyway)")
    with warnings.catch_warnings():  # the archive's read-only buffers, which inference never writes
        warnings.filterwarnings("ignore", message="The given buffer is not writable")
        ep = torch.export.load(program)
    src = torch.device(meta.get("exported_on", "cpu"))
    if src.type != dev.type or (src.index or 0) != (dev.index or 0):
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, dev)
    return ExportedPredictor(ep, meta, dev)


def _fixed_or_symbolic(example: list, symbolic_batch: bool):
    return symbolic_batch_specs(example) if symbolic_batch else None


def _baked(predictor) -> dict:
    return {"temperature": float(predictor.temperature), "quantize": predictor.quantize}


def export_mmbt_predictor(predictor, path: str, *, txt_len: int, image_size: int = 224,
                          symbolic_batch: bool = True, fixed_batch: int = 1,
                          with_ablations: bool = False) -> None:
    """Export a :class:`~multimodal_uncertainty_tpu_torch.serving.MMBTPredictor`'s
    forward ``(txt_ids, mask, segment, img[, keep]) -> probs`` at text length
    ``txt_len``. ``with_ablations=True`` adds the boolean keep mask over the
    image + text sequence (the encoder's ``seq_keep_mask``), so the artifact
    runs the image-only / text-only ablations of ``--uncertainty``; meta records
    ``ablations`` and ``num_image_embeds`` for the micro-batcher's masks."""
    from multimodal_uncertainty_tpu_torch.serving import MMBTProbs

    nb = _EXAMPLE_BATCH if symbolic_batch else int(fixed_batch)
    dev = predictor.device
    n_img_tok = int(predictor.model.enc.num_image_embeds) + 2
    example = [torch.zeros((nb, txt_len), dtype=torch.int64, device=dev),
               torch.ones((nb, txt_len), dtype=torch.int64, device=dev),
               torch.zeros((nb, txt_len), dtype=torch.int64, device=dev),
               torch.zeros((nb, image_size, image_size, 3), device=dev)]
    if with_ablations:
        example.append(torch.ones((nb, n_img_tok + txt_len), dtype=torch.bool, device=dev))
    save_exported(path, MMBTProbs(predictor.model, predictor.temperature), example,
                  dynamic_shapes=_fixed_or_symbolic(example, symbolic_batch), meta={
                      "family": "mmbt", **_baked(predictor), "txt_len": txt_len,
                      "image_size": image_size,
                      "fixed_batch": None if symbolic_batch else int(fixed_batch),
                      "ablations": with_ablations,
                      "num_image_embeds": n_img_tok - 2,
                      "outputs": "class probabilities"})


def export_vilt_predictor(predictor, path: str, *, txt_len: int,
                          image_size: Optional[int] = None, symbolic_batch: bool = True,
                          fixed_batch: int = 1) -> None:
    """Export a :class:`~multimodal_uncertainty_tpu_torch.serving.ViltPredictor`'s
    forward ``(input_ids, attention_mask, token_type_ids, pixel_values (B, H,
    W, 3), pixel_mask (B, H, W) uint8) -> probs`` at text length ``txt_len``
    (at most the position table's 40)."""
    from multimodal_uncertainty_tpu_torch.serving import ViltProbs

    size = image_size or predictor.model.config.image_size
    nb = _EXAMPLE_BATCH if symbolic_batch else int(fixed_batch)
    dev = predictor.device
    example = [torch.zeros((nb, txt_len), dtype=torch.int64, device=dev),
               torch.ones((nb, txt_len), dtype=torch.int64, device=dev),
               torch.zeros((nb, txt_len), dtype=torch.int64, device=dev),
               torch.zeros((nb, size, size, 3), device=dev),
               torch.ones((nb, size, size), dtype=torch.uint8, device=dev)]
    save_exported(path, ViltProbs(predictor.model, predictor.temperature), example,
                  dynamic_shapes=_fixed_or_symbolic(example, symbolic_batch), meta={
                      "family": "vilt", **_baked(predictor), "txt_len": txt_len,
                      "image_size": size,
                      "fixed_batch": None if symbolic_batch else int(fixed_batch),
                      "outputs": "class probabilities"})


def export_fusion_predictor(predictor, path: str, *, img_len: int, txt_len: int,
                            embed_dim: int = 768, txt_embed_dim: Optional[int] = None,
                            symbolic_batch: bool = True, symbolic_lengths: bool = False,
                            fixed_batch: int = 1) -> None:
    """Export a :class:`~multimodal_uncertainty_tpu_torch.serving.FusionPredictor`'s
    padded forward ``(img, txt, img_mask, txt_mask) -> ensemble-mean probs``.
    ``img_len`` / ``txt_len`` fix the padded lengths; with
    ``symbolic_lengths=True`` they are dims as well, multiples of the
    predictor's ``pad_multiple`` (img_len / txt_len then only document the
    meta), one program for every padding. ``fixed_batch`` bakes the batch
    size when ``symbolic_batch`` is off."""
    from multimodal_uncertainty_tpu_torch.serving import FusionProbs

    if symbolic_lengths and not symbolic_batch:
        raise ValueError("symbolic_lengths requires symbolic_batch")
    d_i, d_t = embed_dim, txt_embed_dim or embed_dim
    nb = _EXAMPLE_BATCH if symbolic_batch else int(fixed_batch)
    pad = predictor.pad_multiple
    li, lt = (2 * pad, 2 * pad) if symbolic_lengths else (img_len, txt_len)
    dev = predictor.device
    example = [torch.zeros((nb, li, d_i), device=dev), torch.zeros((nb, lt, d_t), device=dev),
               torch.ones((nb, li), dtype=torch.bool, device=dev),
               torch.ones((nb, lt), dtype=torch.bool, device=dev)]
    dynamic = _fixed_or_symbolic(example, symbolic_batch)
    if symbolic_lengths:
        b = dynamic[0][0]
        # "li" / "lt" name sympy functions: the dims count blocks of ``pad`` tokens
        li_d = pad * torch.export.Dim("li_blocks", min=1, max=_MAX_LEN_BLOCKS)
        lt_d = pad * torch.export.Dim("lt_blocks", min=1, max=_MAX_LEN_BLOCKS)
        dynamic = ({0: b, 1: li_d}, {0: b, 1: lt_d}, {0: b, 1: li_d}, {0: b, 1: lt_d})
    save_exported(path, FusionProbs(predictor.model, predictor.temperature), example,
                  dynamic_shapes=dynamic, meta={
                      "family": "flava_fusion", **_baked(predictor), "img_len": img_len,
                      "txt_len": txt_len, "img_dim": d_i, "txt_dim": d_t,
                      "symbolic_lengths": symbolic_lengths, "pad_multiple": pad,
                      "fixed_batch": None if symbolic_batch else int(fixed_batch),
                      "outputs": "ensemble-mean class probabilities"})


def _coalesced_batch(n: int, fixed_b, buckets) -> int:
    """Program batch size for ``n`` coalesced requests: a fixed-batch artifact
    runs at its baked size; a symbolic-batch one pads up to the live
    predictors' buckets, so the card sees the same few shapes."""
    if fixed_b is not None:
        return int(fixed_b)
    return _bucket_for(n, sorted(buckets))


def _diagnosed(full: np.ndarray, img_only: np.ndarray, txt_only: np.ndarray, n: int) -> list:
    diag = {"confidence": full.max(-1),
            "image_sensitivity": np.abs(full - txt_only).max(-1),
            "text_sensitivity": np.abs(full - img_only).max(-1)}
    return [(full[i], {k: v[i] for k, v in diag.items()}) for i in range(n)]


def fusion_artifact_micro_batcher(loaded: ExportedPredictor, *, max_batch: int = 32,
                                  max_wait_ms: float = 5.0, max_pending=None,
                                  uncertainty: bool = False,
                                  batch_buckets: Sequence[int] = (8, 32)) -> MicroBatcher:
    """A MicroBatcher over a loaded fusion artifact (``predict --artifact DIR
    --serve``). Samples are ``(img (L_i, D), txt (L_t, D))`` pairs, padded to
    the baked lengths with true-length masks; a symbolic-lengths artifact
    takes any length and pads to the coalesced batch's longest, rounded up to
    its ``pad_multiple``. ``uncertainty=True`` returns ``(probs, diag)`` a
    sample: the masks are inputs, so the image-only / text-only ablations run
    through the same program (three calls a coalesced batch)."""
    baked_li, baked_lt = int(loaded.meta["img_len"]), int(loaded.meta["txt_len"])
    sym_len = bool(loaded.meta.get("symbolic_lengths"))
    pad = int(loaded.meta.get("pad_multiple", 32))
    fixed_b = loaded.meta.get("fixed_batch")
    if fixed_b is not None:
        max_batch = min(max_batch, int(fixed_b))

    def predict_batch(samples):
        n = len(samples)
        nb = _coalesced_batch(n, fixed_b, batch_buckets)
        if sym_len:
            li = _round_up(max(a.shape[0] for a, _ in samples), pad)
            lt = _round_up(max(b.shape[0] for _, b in samples), pad)
        else:
            li, lt = baked_li, baked_lt
        img = np.zeros((nb, li, samples[0][0].shape[-1]), np.float32)
        txt = np.zeros((nb, lt, samples[0][1].shape[-1]), np.float32)
        im = np.zeros((nb, li), bool)
        tm = np.zeros((nb, lt), bool)
        for i, (a, b) in enumerate(samples):
            if a.shape[0] > li or b.shape[0] > lt:
                raise ValueError(f"sample ({a.shape[0]}, {b.shape[0]}) exceeds the artifact's "
                                 f"baked lengths ({li}, {lt})")
            img[i, : a.shape[0]], txt[i, : b.shape[0]] = a, b
            im[i, : a.shape[0]], tm[i, : b.shape[0]] = True, True
        full = loaded(img, txt, im, tm)[:n]
        if not uncertainty:
            return [full[i] for i in range(n)]
        img_only = loaded(img, txt, im, np.zeros_like(tm))[:n]
        txt_only = loaded(img, txt, np.zeros_like(im), tm)[:n]
        return _diagnosed(full, img_only, txt_only, n)

    return MicroBatcher(predict_batch, max_batch=max_batch, max_wait_ms=max_wait_ms,
                        max_pending=max_pending)


def mmbt_artifact_micro_batcher(loaded: ExportedPredictor, *, max_batch: int = 32,
                                max_wait_ms: float = 5.0, max_pending=None,
                                uncertainty: bool = False,
                                batch_buckets: Sequence[int] = (8, 32)) -> MicroBatcher:
    """A MicroBatcher over a loaded MMBT artifact; samples ``(token_ids,
    segment, image)`` as ``serving.mmbt_micro_batcher``'s. Text pads to the
    baked ``txt_len`` (longer samples are refused). ``uncertainty=True`` needs
    an artifact exported ``with_ablations=True``: the keep masks are then
    inputs, built here from meta (image-only keeps the image segment;
    text-only keeps [CLS] and the text)."""
    lt, size = int(loaded.meta["txt_len"]), int(loaded.meta["image_size"])
    has_ablations = bool(loaded.meta.get("ablations"))
    if uncertainty and not has_ablations:
        raise ValueError("uncertainty=True needs an artifact exported with_ablations=True "
                         "(this one fixes the full forward)")
    n_img_tok = int(loaded.meta.get("num_image_embeds", 3)) + 2
    total = n_img_tok + lt
    fixed_b = loaded.meta.get("fixed_batch")
    if fixed_b is not None:
        max_batch = min(max_batch, int(fixed_b))

    def predict_batch(samples):
        n = len(samples)
        nb = _coalesced_batch(n, fixed_b, batch_buckets)
        txt = np.zeros((nb, lt), np.int64)
        seg = np.zeros((nb, lt), np.int64)
        mask = np.zeros((nb, lt), np.int64)
        img = np.zeros((nb, size, size, 3), np.float32)
        for i, (ids, segment, image) in enumerate(samples):
            if len(ids) > lt:
                raise ValueError(f"sample text length {len(ids)} exceeds the artifact's baked "
                                 f"txt_len {lt}")
            if image.shape[:2] != (size, size):
                raise ValueError(f"image {image.shape[:2]} != baked size ({size}, {size})")
            txt[i, : len(ids)], seg[i, : len(ids)], mask[i, : len(ids)] = ids, segment, 1
            img[i] = image
        extra = (np.ones((nb, total), bool),) if has_ablations else ()
        full = loaded(txt, mask, seg, img, *extra)[:n]
        if not uncertainty:
            return [full[i] for i in range(n)]
        img_only_keep = np.zeros((nb, total), bool)
        img_only_keep[:, :n_img_tok] = True
        txt_only_keep = np.ones((nb, total), bool)
        txt_only_keep[:, 1:n_img_tok] = False
        img_only = loaded(txt, mask, seg, img, img_only_keep)[:n]
        txt_only = loaded(txt, mask, seg, img, txt_only_keep)[:n]
        return _diagnosed(full, img_only, txt_only, n)

    return MicroBatcher(predict_batch, max_batch=max_batch, max_wait_ms=max_wait_ms,
                        max_pending=max_pending)


def vilt_artifact_micro_batcher(loaded: ExportedPredictor, *, max_batch: int = 32,
                                max_wait_ms: float = 5.0, max_pending=None,
                                uncertainty: bool = False,
                                batch_buckets: Sequence[int] = (8, 32)) -> MicroBatcher:
    """A MicroBatcher over a loaded ViLT artifact; samples are processor dicts
    as ``serving.vilt_micro_batcher``'s (a sample without a pixel mask gets
    ones). ``uncertainty=True`` runs the text-CLS-only and pixel-masked
    ablations through the same program, the masks being inputs
    (``ViltPredictor.predict(ablate=...)``'s conventions)."""
    lt, size = int(loaded.meta["txt_len"]), int(loaded.meta["image_size"])
    fixed_b = loaded.meta.get("fixed_batch")
    if fixed_b is not None:
        max_batch = min(max_batch, int(fixed_b))

    def predict_batch(samples):
        n = len(samples)
        nb = _coalesced_batch(n, fixed_b, batch_buckets)
        ids, am, tt = (np.zeros((nb, lt), np.int64) for _ in range(3))
        pv = np.zeros((nb, size, size, 3), np.float32)
        pm = np.zeros((nb, size, size), np.uint8)
        for i, s in enumerate(samples):
            n_tok = len(s["input_ids"])
            if n_tok > lt:
                raise ValueError(f"sample text length {n_tok} exceeds the artifact's baked "
                                 f"txt_len {lt}")
            ids[i, :n_tok] = s["input_ids"]
            am[i, :n_tok] = s.get("attention_mask", np.ones(n_tok, np.int64))
            tt[i, :n_tok] = s.get("token_type_ids", np.zeros(n_tok, np.int64))
            img = np.asarray(s["pixel_values"])
            if img.shape[:2] != (size, size):
                raise ValueError(f"pixels {img.shape[:2]} != baked size ({size}, {size})")
            pv[i] = img
            pm[i] = np.asarray(s["pixel_mask"]) > 0 if "pixel_mask" in s else 1
        full = loaded(ids, am, tt, pv, pm)[:n]
        if not uncertainty:
            return [full[i] for i in range(n)]
        am_cls = np.zeros_like(am)
        am_cls[:, 0] = 1  # text ablated: only the text [CLS] stays
        img_only = loaded(ids, am_cls, tt, pv, pm)[:n]
        txt_only = loaded(ids, am, tt, pv, np.zeros_like(pm))[:n]
        return _diagnosed(full, img_only, txt_only, n)

    return MicroBatcher(predict_batch, max_batch=max_batch, max_wait_ms=max_wait_ms,
                        max_pending=max_pending)


def artifact_micro_batcher(loaded: ExportedPredictor, **kw) -> MicroBatcher:
    """The family's micro-batcher over any loaded artifact (``meta.family``)."""
    family = loaded.meta.get("family")
    if family == "flava_fusion":
        return fusion_artifact_micro_batcher(loaded, **kw)
    if family == "mmbt":
        return mmbt_artifact_micro_batcher(loaded, **kw)
    if family == "vilt":
        return vilt_artifact_micro_batcher(loaded, **kw)
    raise ValueError(f"unknown artifact family: {family!r}")
