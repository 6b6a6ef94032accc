"""FashionMNIST in four views (port of ``data/fmnist.py``).

Each 28x28 image is split into four 14x14 quarters stacked as views: 0
upper-left, 1 upper-right, 2 lower-left, 3 lower-right, pixel values scaled
to [0, 1]. The crop is one reshape over the whole split: (N, 4, 1, 14, 14)
float32 arrays.

Data: the idx-ubyte files under ``$DATA_DIR/FashionMNIST/raw`` (torchvision's
layout; gzipped files are read too). Without them, or with ``synthetic=True``,
a class-structured stand-in drawn from the seed takes their place, the same
arrays bit for bit as the JAX package's.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from multimodal_uncertainty_tpu_torch.data.loaders import ArrayLoader


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def write_idx(path: str, array: np.ndarray) -> None:
    """Write a uint8 array as an idx-ubyte file (``_read_idx``'s format:
    magic 0x0000080N, N big-endian uint32 dims, the bytes)."""
    a = np.ascontiguousarray(array, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | a.ndim))
        f.write(struct.pack(">" + "I" * a.ndim, *a.shape))
        f.write(a.tobytes())


def quarter_crop(images: np.ndarray) -> np.ndarray:
    """(N, 28, 28) uint8 / float -> (N, 4, 1, 14, 14) float32 (uint8 scaled to [0, 1])."""
    n, h, w = images.shape
    if (h, w) != (28, 28):
        raise ValueError(f"FashionMNIST images are 28 x 28, got {h} x {w}")
    x = images.reshape(n, 2, 14, 2, 14).transpose(0, 1, 3, 2, 4)
    x = x.reshape(n, 4, 1, 14, 14).astype(np.float32)  # (0,0) UL, (0,1) UR, (1,0) LL, (1,1) LR
    if images.dtype == np.uint8:
        x /= 255.0
    return x


def _synthetic_split(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Class-structured synthetic images: a smooth template per class plus
    noise, so a model can fit them."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int64)
    yy, xx = np.meshgrid(np.arange(28), np.arange(28), indexing="ij")
    templates = np.stack([(np.sin(xx / 3.0 + c) + np.cos(yy / 2.0 + 2 * c)) * 0.25 + 0.5
                          for c in range(10)])
    imgs = templates[labels] + rng.normal(0, 0.08, size=(n, 28, 28))
    return np.clip(imgs, 0, 1).astype(np.float32), labels


def load_fmnist_arrays(datapath: str, train: bool, *, synthetic: bool = False,
                       synthetic_n: int = 512, seed: int = 777) -> Tuple[np.ndarray, np.ndarray]:
    """(images (N, 28, 28), labels (N,) int64) of the train or t10k split;
    the synthetic stand-in (``synthetic_n`` train rows, a quarter of that
    for test, seeded ``seed + train``) when asked for or when the files are
    missing."""
    prefix = "train" if train else "t10k"
    raw = os.path.join(datapath, "FashionMNIST", "raw")
    img_path = os.path.join(raw, f"{prefix}-images-idx3-ubyte")
    lbl_path = os.path.join(raw, f"{prefix}-labels-idx1-ubyte")
    if not synthetic:
        for suffix in ("", ".gz"):
            if os.path.exists(img_path + suffix) and os.path.exists(lbl_path + suffix):
                return (_read_idx(img_path + suffix),
                        _read_idx(lbl_path + suffix).astype(np.int64))
    return _synthetic_split(synthetic_n if train else synthetic_n // 4, seed + train)


def get_fmnist(datapath: Optional[str] = None, batch_size: int = 128, download: bool = False,
               shuffle: bool = True, sample_size: Optional[int] = None, seed: int = 777,
               synthetic: bool = False, synthetic_n: int = 512):
    """(train loader, test loader, None) of (B, 4, 1, 14, 14) float32 batches
    with int64 labels, the reference ``get_fmnist``'s signature and return;
    the train loader shuffles by ``(seed, epoch)`` when ``shuffle``.
    ``download`` is taken and ignored: there is no network."""
    del download
    datapath = datapath or os.environ.get("DATA_DIR", ".")
    tr_imgs, tr_lbls = load_fmnist_arrays(datapath, True, synthetic=synthetic,
                                          synthetic_n=synthetic_n, seed=seed)
    te_imgs, te_lbls = load_fmnist_arrays(datapath, False, synthetic=synthetic,
                                          synthetic_n=synthetic_n, seed=seed)
    tr_x, te_x = quarter_crop(tr_imgs), quarter_crop(te_imgs)
    if sample_size is not None:
        tr_x, tr_lbls = tr_x[:sample_size], tr_lbls[:sample_size]
    train_loader = ArrayLoader((tr_x, tr_lbls), batch_size, shuffle=shuffle, seed=seed)
    test_loader = ArrayLoader((te_x, te_lbls), batch_size, shuffle=False)
    return train_loader, test_loader, None
