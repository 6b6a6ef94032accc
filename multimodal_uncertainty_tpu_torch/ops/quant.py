"""Int8 quantized matmuls for serving: dynamic W8A8 and weight-only (port of
``ops/quant.py``).

Two modes, the JAX package's:

* ``"int8"``: dynamic W8A8. Per-token symmetric activation scales and
  per-output-channel symmetric weight scales, an int8 x int8 -> int32
  product, an fp32 rescale. No calibration pass.
* ``"int8_weight"``: weight-only. The weights are quantized per output
  channel to int8 and dequantized to the activation dtype before the
  product; the activations are untouched.

Layout: the port's weight is ``(out, in)`` (``torch.nn.Linear``'s), the JAX
kernel ``(in, out)``: the per-channel scale is the abs-max over ``in``, dim 1
here, axis 0 there. Rounding is ``round(x / s)``, half to even in both
packages, with the scales floored at 1e-12. The numbers equal the JAX
functions'.

The int8 product is :func:`int8_mm`, the operator ``torch.ops.mmu.int8_mm``:
on a CUDA tensor ``torch._int_mm`` (cuBLASLt's int8 GEMM; the JAX package
computes this product with ``lax.dot_general`` outside any Pallas kernel, so
it is no ported kernel), its operands zero-padded to the shapes cuBLASLt
takes (more than 16 rows, K and N multiples of 8) and the result sliced back;
on a CPU tensor the same integer product, exact, through a float64 matmul
(every partial sum of int8 products is an integer below 2^53). Each CUDA
product adds one to ``int8_mm_cuda.launches``.

How a model runs quantized: :func:`~multimodal_uncertainty_tpu_torch.models.
layers.set_quantize` sets the mode on every ``Linear`` of a model, which
quantizes its weight once into buffers (the same numbers as quantizing on each
call, as JAX does inside its traced program).
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch
from torch.nn import functional as F

MODES = ("int8", "int8_weight")
SCALE_FLOOR = 1e-12
# cuBLASLt's int8 GEMM takes more than 16 rows and K, N multiples of 8
_MIN_ROWS = 17
_ALIGN = 8
_count_lock = threading.Lock()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact: each product and
    partial sum is an integer below 2^53, so a float64 matmul gives it."""
    return torch.matmul(a.double(), b.double()).round_().to(torch.int32)


def int8_mm_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` on CUDA tensors: (M, K) int8 @ (K, N) int8 -> (M, N)
    int32. Rows are padded with zeros to at least 17, K and N to multiples of
    8 (zero columns of ``a`` meet zero rows of ``b``; padded outputs are
    sliced off) and ``b`` is made column-major, the rules ``torch._int_mm``
    keeps on the card (torch 2.11, CUDA 12.8), so every shape of the model
    paths takes this route. Adds one
    to ``int8_mm_cuda.launches``."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"int8_mm_cuda needs CUDA tensors on one device, got {a.device}, "
                         f"{b.device}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"int8_mm_cuda takes int8 operands, got {a.dtype}, {b.dtype}")
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, _MIN_ROWS), _round_up(k, _ALIGN), _round_up(n, _ALIGN)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    # b column-major: cuBLASLt refuses a row-major one at some shapes (17 x 64 @ 64 x 104)
    bt = F.pad(b.t(), (0, kp - k, 0, np_ - n)) if (kp, np_) != (k, n) else b.t()
    out = torch._int_mm(a.contiguous(), bt.contiguous().t())
    with _count_lock:
        int8_mm_cuda.launches += 1
    return out[:m, :n] if (mp, np_) != (m, n) else out


int8_mm_cuda.launches = 0


def _int8_mm_route(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cuda":
        return int8_mm_cuda(a, b)
    if a.device.type != "cpu":
        raise ValueError(f"int8_mm: unsupported device {a.device}")
    return int8_mm_plain(a, b)


# the int8 product as one operator, ``torch.ops.mmu.int8_mm``, so an exported program keeps it
# (and its padding) whatever its batch (registered as ``ops/attention.py``'s)
_LIB = torch.library.Library("mmu", "FRAGMENT")
_LIB.define("int8_mm(Tensor a, Tensor b) -> Tensor")
for _key in ("CPU", "CUDA"):
    _LIB.impl("int8_mm", lambda a, b: _int8_mm_route(a, b), _key)


@torch.library.register_fake("mmu::int8_mm")
def _(a, b):
    return a.new_empty((a.shape[0], b.shape[1]), dtype=torch.int32)


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32: :func:`int8_mm_cuda` on a
    CUDA tensor, :func:`int8_mm_plain` on a CPU tensor."""
    return torch.ops.mmu.int8_mm(a, b)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax / 127, 1e-12)``. The 127 is a tensor on amax's device: CUDA
    divides by a Python scalar as a product with its reciprocal, one ulp off
    the quotient JAX and the CPU compute, which moves ties of the rounding."""
    return torch.clamp(amax / torch.full((), 127.0, device=amax.device), min=SCALE_FLOOR)


def weight_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of an (out, in) weight:
    -> wq (out, in) int8, ws (out,) fp32 with w ~ wq * ws[:, None]."""
    w32 = w.float()
    ws = _scale(w32.abs().amax(dim=1))
    wq = torch.round(w32 / ws[:, None]).to(torch.int8)
    return wq, ws


def activation_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 quantization over the last axis: -> xq of x's
    shape, int8, and xs (..., 1) fp32."""
    x32 = x.float()
    xs = _scale(x32.abs().amax(dim=-1, keepdim=True))
    return torch.round(x32 / xs).to(torch.int8), xs


def int8_dot_q(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Dynamic W8A8 on a quantized weight: (..., K) @ (N, K)^T -> (..., N) in
    x's dtype: x quantized per token, the int32 product, the fp32 rescale
    ``acc * xs * ws`` (JAX's order)."""
    xq, xs = activation_int8(x)
    acc = int8_mm(xq.reshape(-1, xq.shape[-1]), wq.t())
    acc = acc.reshape(*x.shape[:-1], wq.shape[0])
    return (acc.float() * xs * ws).to(x.dtype)


def int8_weight_dot_q(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Weight-only int8 on a quantized weight: dequantize to x's dtype, then
    the product (``F.linear``; TF32 stays off on the card)."""
    return F.linear(x, (wq.float() * ws[:, None]).to(x.dtype))


def int8_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dynamic W8A8 matmul (..., K) @ (N, K)^T -> (..., N) in x's dtype (the
    JAX package's ``int8_dot`` with the weight transposed)."""
    return int8_dot_q(x, *weight_int8(w))


def int8_weight_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weight-only int8 (the JAX package's ``int8_weight_dot``)."""
    return int8_weight_dot_q(x, *weight_int8(w))


def check_mode(mode: Optional[str]) -> Optional[str]:
    if mode is not None and mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}; use one of {MODES}")
    return mode


def quant_dot(x: torch.Tensor, w: torch.Tensor, mode: Optional[str]) -> torch.Tensor:
    """``x @ w.T`` under ``mode``: ``"int8"``, ``"int8_weight"`` or None
    (full precision)."""
    if check_mode(mode) == "int8":
        return int8_dot(x, w)
    if mode == "int8_weight":
        return int8_weight_dot(x, w)
    return F.linear(x, w.to(x.dtype))
