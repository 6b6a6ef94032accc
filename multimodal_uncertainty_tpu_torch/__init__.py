"""multimodal_uncertainty_tpu_torch — the PyTorch / CUDA port.

A second package beside ``multimodal_uncertainty_tpu`` (the JAX reference),
written in PyTorch for one NVIDIA H100. It imports neither JAX nor the JAX
package. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU device they raise.

Environment configuration mirrors the JAX package: ``DATA_DIR`` and
``RESULTS_DIR`` environment variables with local defaults.
"""
from __future__ import annotations

import logging
import os

__version__ = "0.1.0"

DATA_DIR = os.environ.setdefault(
    "DATA_DIR", os.path.join(os.path.dirname(os.path.dirname(__file__)), "data_dir")
)
RESULTS_DIR = os.environ.setdefault(
    "RESULTS_DIR", os.path.join(os.path.dirname(os.path.dirname(__file__)), "results")
)

logging.getLogger(__name__).addHandler(logging.NullHandler())
