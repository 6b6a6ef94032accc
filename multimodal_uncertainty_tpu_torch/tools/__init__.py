"""Microbenchmarks of the port's kernels (port of the repository's root
``tools/bench_flash.py`` and ``tools/bench_dw.py``, and the attention
kernels' redesign rows), run as modules:

    python -m multimodal_uncertainty_tpu_torch.tools.bench_flash
    python -m multimodal_uncertainty_tpu_torch.tools.bench_dw
    python -m multimodal_uncertainty_tpu_torch.tools.bench_attention
    python -m multimodal_uncertainty_tpu_torch.tools.bench_quant
    python -m multimodal_uncertainty_tpu_torch.tools.bench_export

They run on the card by default; ``--device cpu`` takes the plain route.
``python -m multimodal_uncertainty_tpu_torch.tools.calibrate`` fits a serving
temperature on prediction dumps (numpy only).
"""
from __future__ import annotations

import subprocess
import time
from typing import Callable

import torch


def elapsed_ms(device: torch.device, body: Callable[[], torch.Tensor]) -> float:
    """Milliseconds that ``body`` takes, its result consumed in full. On the
    card: CUDA events around it, read after a synchronise; on the CPU: the
    host clock."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = body()
        end.record()
        torch.cuda.synchronize(device)
        float(out.float().sum())
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    float(body().float().sum())
    return (time.perf_counter() - t0) * 1e3


def card_name(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (``"cpu"`` on the CPU): every time a tool
    prints stands beside them."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[device.index or 0]
