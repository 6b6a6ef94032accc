"""Image preprocessing (port of ``data/images.py``): decode, resize and
center-crop on the host, normalise on the device.

The reference's chain (``src/dataset.py:488-498``) is Resize(256) of the
shorter side (bilinear), CenterCrop(224), ToTensor, Normalize(mean, std).
Images travel to the device as uint8 and are normalised there.

Decoding uses PIL where it is installed. Where it is not (the machine with
the card has none), :func:`decode_rgb` reads binary PPM (``P6``) files itself
and raises on any other format, and :func:`resize_center_crop` raises where a
resize is needed. An image whose shorter side is already 256 needs none: the
resize is the identity there (PIL returns a copy) and the crop is exact.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

FOOD101_MEAN = (0.46777044, 0.44531429, 0.40661017)
FOOD101_STD = (0.12221994, 0.12145835, 0.14380469)


def _pil_image():
    """PIL's ``Image`` module, or None where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def read_ppm(path: str) -> np.ndarray:
    """A binary PPM (``P6``, maxval 255) -> (H, W, 3) uint8. Raises on any
    other format."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:  # magic, width, height, maxval; '#' comments between
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos)
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    if fields[0] != b"P6" or int(fields[3]) != 255:
        raise ValueError(f"{path}: not a binary PPM (P6, maxval 255); without PIL "
                         f"only P6 images can be read")
    w, h = int(fields[1]), int(fields[2])
    pixels = np.frombuffer(data, np.uint8, count=h * w * 3, offset=pos + 1)
    return pixels.reshape(h, w, 3).copy()


def write_ppm(path: str, img: np.ndarray) -> None:
    """(H, W, 3) uint8 -> a binary PPM (``P6``) file."""
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def decode_rgb(path: str):
    """Open an image as RGB: a PIL image where PIL is installed; otherwise an
    (H, W, 3) uint8 array from a ``P6`` file."""
    image = _pil_image()
    if image is None:
        return read_ppm(path)
    return image.open(path).convert("RGB")


def resize_center_crop(img, resize: int = 256, crop: int = 224) -> np.ndarray:
    """A PIL image or an (H, W, 3) uint8 array -> (crop, crop, 3) uint8 with
    torchvision's semantics: the shorter side to ``resize`` (bilinear), then
    the center crop."""
    if isinstance(img, np.ndarray):
        h, w = img.shape[:2]
    else:
        w, h = img.size
    if w <= h:
        nw, nh = resize, max(1, int(round(h * resize / w)))
    else:
        nh, nw = resize, max(1, int(round(w * resize / h)))
    left = int(round((nw - crop) / 2.0))
    top = int(round((nh - crop) / 2.0))
    if (nw, nh) == (w, h):  # the resize is the identity
        return np.asarray(img, dtype=np.uint8)[top:top + crop, left:left + crop].copy()
    image = _pil_image()
    if image is None:
        raise RuntimeError(f"resizing a {w}x{h} image to a shorter side of {resize} needs PIL, "
                           f"which is not installed")
    if isinstance(img, np.ndarray):
        img = image.fromarray(img)
    img = img.resize((nw, nh), image.BILINEAR)
    img = img.crop((left, top, left + crop, top + crop))
    return np.asarray(img, dtype=np.uint8)


def normalize_on_device(x_uint8: torch.Tensor, mean: Sequence[float],
                        std: Sequence[float]) -> torch.Tensor:
    """(B, H, W, 3) uint8 on the device -> normalised float32."""
    x = x_uint8.float() / 255.0
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean_t) / std_t


def gray_image(size: Tuple[int, int] = (256, 256)) -> np.ndarray:
    """The reference's drop-img substitute: constant 128 RGB
    (``src/dataset.py:396``)."""
    return np.full(size + (3,), 128, dtype=np.uint8)
