"""The ViLT dataset: image and text preprocessed on the host (port of ``data/vilt_data.py``).

Reference ``VILTDataset`` / ``collate_fn_vilt`` / ``get_dataset_vilt``
(``src/dataset.py:229-284, 339-345``), which wrap HF's ``ViltProcessor``; the
JAX package's native equivalent, kept here: the shorter side resized to 384
and a 384 center crop (uint8, normalised with mean = std = 0.5 on the
device), WordPiece ids cut to 40 with [CLS] / [SEP], and a pixel mask of ones
(the fixed square crop). Tokenisation is the port's pure-Python WordPiece,
which gives the ids of the JAX package's native tokenizer. Without PIL only
P6 images whose shorter side is already 384 load (``data/images.py``).
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from multimodal_uncertainty_tpu_torch.data.images import decode_rgb, resize_center_crop
from multimodal_uncertainty_tpu_torch.data.loaders import subset_then_loaders
from multimodal_uncertainty_tpu_torch.data.tokenization import BertTokenizer


def read_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def load_error_cases(prefix_dir: str, phase: str) -> List[int]:
    """Row indices FLAVA failed to encode (``flava_embeds/<phase>_error_cases.txt``),
    removed from the hateful-memes rows as the reference does."""
    with open(os.path.join(prefix_dir, "flava_embeds", f"{phase}_error_cases.txt")) as f:
        return [int(x) for x in f.read().split("\n")[:-1]]


class VILTDataset:
    """``{phase}.jsonl`` rows ``{label, text, img}`` -> one processor dict
    each: ``input_ids`` / ``attention_mask`` / ``token_type_ids`` (40,)
    int64, ``pixel_values`` (384, 384, 3) uint8 and ``labels``."""

    def __init__(self, prefix_dir: str, phase: str, label_dict, error_cases_remover=False, *,
                 vocab_file: str, max_length: int = 40, image_size: int = 384):
        rows = read_jsonl(os.path.join(prefix_dir, f"{phase}.jsonl"))
        if error_cases_remover:
            drop = set(load_error_cases(prefix_dir, phase))
            rows = [r for i, r in enumerate(rows) if i not in drop]
        self.rows = rows
        self.label_dict = label_dict
        self.data_path = prefix_dir
        self.tokenizer = BertTokenizer(vocab_file)
        self.max_length = max_length
        self.image_size = image_size
        self.cls_id = self.tokenizer.vocab.get("[CLS]", 101)
        self.sep_id = self.tokenizer.vocab.get("[SEP]", 102)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        row = self.rows[idx]
        image = decode_rgb(os.path.join(self.data_path, row["img"]))
        pixels = resize_center_crop(image, self.image_size, self.image_size)
        words = self.tokenizer.tokenize(row["text"])[: self.max_length - 2]
        ids = [self.cls_id] + self.tokenizer.convert_tokens_to_ids(words) + [self.sep_id]
        input_ids = np.zeros(self.max_length, np.int64)
        attention = np.zeros(self.max_length, np.int64)
        input_ids[: len(ids)] = ids
        attention[: len(ids)] = 1
        return {
            "input_ids": input_ids,
            "attention_mask": attention,
            "token_type_ids": np.zeros(self.max_length, np.int64),
            "pixel_values": pixels,  # uint8 HWC; normalised on the device
            "labels": np.int64(self.label_dict.index(row["label"])),
        }


def collate_fn_vilt(batch):
    """Stacked processor dicts plus an all-ones (B, H, W) int64 pixel mask ->
    (dict of arrays, labels)."""
    out = {k: np.stack([item[k] for item in batch])
           for k in ("input_ids", "attention_mask", "token_type_ids", "pixel_values")}
    h, w = out["pixel_values"].shape[1:3]
    out["pixel_mask"] = np.ones((len(batch), h, w), np.int64)
    labels = np.asarray([item["labels"] for item in batch], np.int64)
    return out, labels


def get_dataset_vilt(args, datapath: str):
    """Train (shuffled by ``(seed, epoch)``, cut to ``args.sample_size``), dev
    and test loaders; the vocabulary is ``args.vocab_file`` or
    ``<datapath>/vocab.txt``."""
    vocab_file = getattr(args, "vocab_file", None) or os.path.join(datapath, "vocab.txt")

    def make(phase):
        return VILTDataset(datapath, phase, args.labels, args.error_cases_remover,
                           vocab_file=vocab_file)

    return subset_then_loaders(make("train"), make("dev"), make("test"), collate_fn_vilt, args)
