"""Shared artifact assembly for the eval sweeps (port of ``evals/artifacts.py``,
numpy only).

The sweeps accumulate per-batch prediction blocks and publish one array
(reference artifact contract, e.g. (S, 43, E, C) — up to ~1.7 GB for the
UPMC-Food-101 test split). A plain ``np.concatenate`` + ``np.save``
briefly holds TWO full copies in RAM (the batch list and the
concatenated result); :func:`concat_maybe_memmap` instead writes the
blocks straight into the ``.npy`` via ``open_memmap`` when a path is
given — same on-disk format, peak RAM stays at one copy of the blocks.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def concat_maybe_memmap(
    parts: Sequence[np.ndarray], axis: int = 0, path: Optional[str] = None
) -> np.ndarray:
    """Concatenate ``parts`` along ``axis``; with ``path``, assemble
    directly inside the target ``.npy`` (memory-mapped) and return the
    flushed memmap — byte-identical file to ``np.save`` of the
    concatenation."""
    if path is None:
        return np.concatenate(parts, axis=axis)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    total = sum(p.shape[axis] for p in parts)
    shape = list(parts[0].shape)
    shape[axis] = total
    # match np.concatenate's promotion — parts[0].dtype alone would
    # silently downcast heterogeneous blocks on assignment
    out = np.lib.format.open_memmap(
        path, mode="w+", dtype=np.result_type(*parts), shape=tuple(shape)
    )
    ofs = 0
    index = [slice(None)] * parts[0].ndim
    for p in parts:
        index[axis] = slice(ofs, ofs + p.shape[axis])
        out[tuple(index)] = p
        ofs += p.shape[axis]
    out.flush()
    return out
