"""The raw-pixel Food-101 pipeline of MMBT (port of ``data/food101.py:31-277``).

Reference: ``JsonlDataset`` / ``collate_fn`` / ``get_food101``
(``src/dataset.py:348-545``). Text becomes BERT wordpieces after a [SEP]
start token, cut to ``max_seq_len - num_image_embeds``; the first [SEP]
belongs to the image segment and is dropped, and the text's token types are
1. Images get resize-256 / center-crop-224; ``drop_img_percent`` replaces
images by a gray frame under numpy seed 0. Collation left-aligns the text
with a 0/1 mask, padded to a multiple of 32. Images stay uint8 (the model's
step normalises them on the device). The pure-Python tokenizer is used; the
JAX package's native tokenizer and batch decoder are not ported.
"""
from __future__ import annotations

import json
import os
from collections import Counter
from typing import Callable, List, Optional

import numpy as np

from multimodal_uncertainty_tpu_torch.data.images import (
    decode_rgb,
    gray_image,
    resize_center_crop,
)
from multimodal_uncertainty_tpu_torch.data.loaders import MapLoader
from multimodal_uncertainty_tpu_torch.data.tokenization import BertTokenizer, Vocab, get_vocab
from multimodal_uncertainty_tpu_torch.utils.seeding import numpy_seed


def get_labels_and_frequencies(path: str):
    """The labels of a ``train.jsonl`` in order of first appearance, and their
    counts (reference ``src/dataset.py:408-417``)."""
    label_freqs = Counter()
    with open(path) as f:
        data_labels = [json.loads(line)["label"] for line in f]
    if data_labels and isinstance(data_labels[0], list):
        for row in data_labels:
            label_freqs.update(row)
    else:
        label_freqs.update(data_labels)
    return list(label_freqs.keys()), label_freqs


class JsonlDataset:
    """Reference ``JsonlDataset`` (``src/dataset.py:348-405``): a row is
    (token ids, token types, (224, 224, 3) uint8 image, label index)."""

    def __init__(
        self,
        data_path: str,
        tokenizer: Callable[[str], List[str]],
        vocab: Vocab,
        n_classes: int,
        drop_img_percent: float,
        max_seq_len: int,
        num_image_embeds: int,
        labels: List,
        image_size: int = 224,
    ):
        with open(data_path) as f:
            self.data = [json.loads(line) for line in f]
        self.data_dir = os.path.dirname(data_path)
        self.tokenizer = tokenizer
        self.vocab = vocab
        self.n_classes = n_classes
        self.text_start_token = ["[SEP]"]
        self.labels = labels
        self.image_size = image_size
        with numpy_seed(0):
            for row in self.data:
                if np.random.random() < drop_img_percent:
                    row["img"] = None
        self.max_seq_len = max_seq_len - num_image_embeds

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        row = self.data[index]
        sentence = self.text_start_token + self.tokenizer(row["text"])[: self.max_seq_len - 1]
        unk = self.vocab.stoi["[UNK]"]
        token_ids = np.asarray([self.vocab.stoi.get(w, unk) for w in sentence], np.int64)
        segment = np.zeros(len(sentence), np.int64)
        label = self.labels.index(row["label"])
        if row["img"]:
            image = resize_center_crop(decode_rgb(os.path.join(self.data_dir, row["img"])), 256,
                                       self.image_size)
        else:
            image = resize_center_crop(gray_image(), 256, self.image_size)
        # the first [SEP] belongs to the image segment (reference :399-403)
        return token_ids[1:], segment[1:] + 1, image, label


def collate_fn(batch, pad_multiple: int = 32):
    """Left-aligned padded text and mask, stacked uint8 images (reference
    ``src/dataset.py:420-438``), the length rounded up to ``pad_multiple``.
    Returns ``((text, segment, mask, imgs), targets)``; the model reads
    (txt, mask, segment, img), the reference's transposition, harmless since
    segment and mask are equal (every text token has type 1 and mask 1)."""
    lens = [len(row[0]) for row in batch]
    bsz = len(batch)
    max_seq_len = ((max(lens) + pad_multiple - 1) // pad_multiple) * pad_multiple
    text = np.zeros((bsz, max_seq_len), np.int64)
    segment = np.zeros((bsz, max_seq_len), np.int64)
    mask = np.zeros((bsz, max_seq_len), np.int64)
    imgs = np.stack([row[2] for row in batch])
    targets = np.asarray([row[3] for row in batch], np.int64)
    for i, (row, length) in enumerate(zip(batch, lens)):
        text[i, :length] = row[0]
        segment[i, :length] = row[1]
        mask[i, :length] = 1
    return (text, segment, mask, imgs), targets


def get_food101(
    vocab_file: Optional[str] = None,
    datapath: Optional[str] = None,
    drop_img_percent: float = 0.0,
    max_seq_len: int = 512,
    num_image_embeds: int = 3,
    batch_size: int = 128,
    n_workers: int = 4,
    sample_size: Optional[int] = None,
    seed: int = 42,
):
    """Reference ``get_food101`` (``src/dataset.py:474-545``): train
    (shuffled by ``(seed, epoch)``, cut to ``sample_size``), dev and test
    loaders, the class count and the vocabulary. ``vocab_file`` defaults to
    ``<datapath>/vocab.txt``."""
    datapath = datapath or os.environ["DATA_DIR"]
    if vocab_file is None:
        vocab_file = os.path.join(datapath, "vocab.txt")
    tokenizer = BertTokenizer(vocab_file, do_lower_case=True)
    vocab = get_vocab(vocab_file)
    labels, _ = get_labels_and_frequencies(os.path.join(datapath, "train.jsonl"))
    n_classes = len(labels)

    def make(split):
        return JsonlDataset(os.path.join(datapath, f"{split}.jsonl"), tokenizer.tokenize, vocab,
                            n_classes, drop_img_percent, max_seq_len, num_image_embeds, labels)

    train, dev, test = make("train"), make("dev"), make("test")
    train_loader = MapLoader(train, batch_size, collate_fn, shuffle=True, seed=seed,
                             num_workers=n_workers, sample_size=sample_size)
    val_loader = MapLoader(dev, batch_size, collate_fn, num_workers=n_workers)
    test_loader = MapLoader(test, batch_size, collate_fn, num_workers=n_workers)
    return train_loader, val_loader, test_loader, n_classes, vocab
