"""Device selection for the port's entry points.

The default is the card. Without one the entry points raise; they never carry
on on the CPU unless the caller asked for it with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, int, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``. An integer, or a string of digits such as the
    root CLIs' ``--device 0``, is that GPU's index: ``cuda:N``. On CUDA, TF32
    is switched off for matmuls and convolutions, so the fp32 serving path
    stays fp32, and bf16 matmuls reduce their split-K partial sums in fp32
    (``allow_bf16_reduced_precision_reduction`` off), as JAX's bf16 dots
    accumulate in fp32."""
    if isinstance(device, str) and device.isdigit():
        device = int(device)
    if isinstance(device, int):
        device = f"cuda:{device}"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
