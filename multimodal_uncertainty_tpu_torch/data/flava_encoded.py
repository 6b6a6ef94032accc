"""Packed FLAVA-embedding shards (port of ``data/flava_encoded.py``, numpy only).

A split is packed once into consolidated ``.npy`` shards: ``{phase}_img.npy``
and ``{phase}_txt.npy`` (rows of all samples, concatenated), their row-offset
indexes ``{phase}_img_offsets.npy`` / ``{phase}_txt_offsets.npy``, and
``{phase}_labels.npy``. Rows are read memory-mapped. ``get_dataset_flava``
builds the train / dev / test loaders over them.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


PAD_MULTIPLE = 32


def collate_fn_flava(batch) -> Tuple[Tuple[np.ndarray, np.ndarray], np.ndarray]:
    """Zero-pad variable-length embedding sequences; pad lengths round up to
    ``PAD_MULTIPLE`` so the number of distinct shapes stays bounded."""
    imgs, txts, labels = zip(*batch)
    li = _round_up(max(i.shape[0] for i in imgs), PAD_MULTIPLE)
    lt = _round_up(max(t.shape[0] for t in txts), PAD_MULTIPLE)
    d = imgs[0].shape[-1]
    dtype = imgs[0].dtype
    img_out = np.zeros((len(batch), li, d), dtype)
    txt_out = np.zeros((len(batch), lt, d), dtype)
    for n, (i, t) in enumerate(zip(imgs, txts)):
        img_out[n, : i.shape[0]] = i
        txt_out[n, : t.shape[0]] = t
    return (img_out, txt_out), np.asarray(labels, np.int64)


def _rows_as_float32(rows: np.ndarray) -> np.ndarray:
    """Shards packed as bfloat16 come back from ``np.load`` as raw 2-byte
    void; widen those rows to float32 exactly (bf16 is the top half of an
    fp32). Other dtypes pass through."""
    if rows.dtype.kind == "V" and rows.dtype.itemsize == 2:
        return (rows.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return rows


class PackedFlavaDataset:
    """Memory-mapped consolidated shards; O(1) open, per-row reads."""

    def __init__(self, shard_dir: str, phase: str):
        self.img = np.load(os.path.join(shard_dir, f"{phase}_img.npy"), mmap_mode="r")
        self.txt = np.load(os.path.join(shard_dir, f"{phase}_txt.npy"), mmap_mode="r")
        self.img_off = np.load(os.path.join(shard_dir, f"{phase}_img_offsets.npy"))
        self.txt_off = np.load(os.path.join(shard_dir, f"{phase}_txt_offsets.npy"))
        self.labels = np.load(os.path.join(shard_dir, f"{phase}_labels.npy"))

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        i0, i1 = self.img_off[idx], self.img_off[idx + 1]
        t0, t1 = self.txt_off[idx], self.txt_off[idx + 1]
        return (_rows_as_float32(self.img[i0:i1]), _rows_as_float32(self.txt[t0:t1]),
                int(self.labels[idx]))


def has_packed(shard_dir: str, phase: str) -> bool:
    return os.path.exists(os.path.join(shard_dir, f"{phase}_labels.npy"))


def get_dataset_flava(args, datapath: str):
    """Train / dev / test loaders over the packed shards under
    ``{datapath}/flava_packed`` (the JAX package's ``get_dataset_flava``; its
    legacy file-per-sample layout is not ported: pack it with the JAX
    package's ``pack_split`` first)."""
    from multimodal_uncertainty_tpu_torch.data.loaders import subset_then_loaders

    shard_dir = os.path.join(datapath, "flava_packed")
    missing = [p for p in ("train", "dev", "test") if not has_packed(shard_dir, p)]
    if missing:
        raise FileNotFoundError(
            f"no packed FLAVA shards for {missing} under {shard_dir}: the port reads "
            "packed shards only (the per-file layout is not ported)"
        )
    splits = [PackedFlavaDataset(shard_dir, p) for p in ("train", "dev", "test")]
    return subset_then_loaders(*splits, collate_fn_flava, args)
