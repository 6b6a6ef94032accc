"""A Linear's weight gradient dW = Xᵀ·dY: the hand-written CUDA kernel and its plain version.

Port of ``multimodal_uncertainty_tpu/ops/dw.py``. ``linear_dw(x, w)`` is
``F.linear(x, w)`` whose backward computes dW with the kernel of
``csrc/dw.cu`` (the JAX package's ``dot_general_dw``, whose dW is the Pallas
kernel ``_dw_pallas_2d``); dx = g·W stays a plain product (``torch.matmul``),
as the JAX package leaves it to XLA. ``Linear`` takes this route in training
when its ``fast_dw`` flag is set (``train --fast_dw``) and both its widths are
multiples of 128.

Routing is by device only: a CUDA tensor launches the kernel (or raises), a
CPU tensor takes :func:`dw_plain`. There is no other switch.

Precision: the rows are summed in fp32 whatever the input dtype; the
gradient is cast to x's dtype before the kernel and dW is returned in the
weight's dtype (``dw.py:141-149``).
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Tuple

import torch

TILE = 128  # the kernel's output tile: Din and Dout must be multiples of it
_SLICE = 8  # K rows per slice of the kernel; a split's K range is a multiple of it
_MIN_SPLIT_ROWS = 512  # K is split over blocks only in chunks of at least this many rows
# the bf16 tensor-core kernel: (Dout, Din) output tile, K rows per stage (a split's K range is a
# multiple of it), and the rates k_splits weighs a split's work against its slab traffic with
# (H100 SXM: bf16 tensor cores on 132 SMs, device memory)
TC_TILE = (128, 256)
TC_SLICE = 64
_TC_MAX_SPLITS = 32
_TC_SM_FLOPS = 989e12 / 132
_TC_BYTES = 3.35e12
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def dw_plain(x2d: torch.Tensor, dy2d: torch.Tensor) -> torch.Tensor:
    """(K, Din) x (K, Dout) -> (Dout, Din) fp32: ``dy2d.T @ x2d`` in fp32,
    torch's weight layout (the transpose of what ``_dw_pallas_2d`` returns).
    The CPU route and the reference the kernel is held to on the card."""
    return dy2d.float().t() @ x2d.float()


def k_splits(k: int, din: int, dout: int, sms: int, tc: bool = False) -> Tuple[int, int]:
    """(splits, k_chunk): K is cut into ``splits`` chunks of ``k_chunk`` rows.

    fp32 kernel (``tc`` False): chunks are multiples of its 8-row slice, so
    that about two blocks per SM of a card with ``sms`` SMs are in flight,
    each chunk at least ``_MIN_SPLIT_ROWS`` rows. bf16 tensor-core kernel
    (``tc`` True, one block per SM): chunks are multiples of its 64-row
    stage, and the count is the one that minimises the modelled time, waves
    of (tile, chunk) work units at the tensor rate plus the slabs written and
    summed back at the memory rate, so the units come close to whole waves;
    ties go to fewer splits."""
    if tc:
        return _tc_splits(k, din, dout, sms)
    tiles = (din // TILE) * (dout // TILE)
    splits = max(1, min(math.ceil(2 * sms / tiles), k // _MIN_SPLIT_ROWS))
    chunk = -(-max(k, 1) // splits)
    chunk = -(-chunk // _SLICE) * _SLICE
    return -(-max(k, 1) // chunk), chunk


def _tc_splits(k: int, din: int, dout: int, sms: int) -> Tuple[int, int]:
    rows = max(k, 1)
    tiles = (dout // TC_TILE[0]) * -(-din // TC_TILE[1])
    best = None
    for want in range(1, min(_TC_MAX_SPLITS, max(1, rows // TC_SLICE)) + 1):
        chunk = -(-rows // want)
        chunk = -(-chunk // TC_SLICE) * TC_SLICE
        splits = -(-rows // chunk)
        waves = -(-tiles * splits // sms)
        seconds = waves * chunk * 2 * TC_TILE[0] * TC_TILE[1] / _TC_SM_FLOPS
        if splits > 1:
            seconds += (2 * splits + 1) * dout * din * 4 / _TC_BYTES
        if best is None or seconds < best[0]:
            best = (seconds, splits, chunk)
    return best[1], best[2]


def _check(t: torch.Tensor, name: str, k: int) -> int:
    """Device, dtype, shape and alignment of an operand; returns its row stride."""
    if t.device.type != "cuda":
        raise ValueError(f"dw_cuda: {name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"dw_cuda: {name} dtype {t.dtype} not supported")
    if t.dim() != 2 or t.shape[0] != k or t.shape[1] % TILE:
        raise ValueError(f"dw_cuda: {name} must be ({k}, a multiple of {TILE}), "
                         f"got {tuple(t.shape)}")
    # fp32: the kernel loads 4 neighbouring elements at a time; bf16: the TMA
    # copies rows of 16-byte multiples from a 16-byte aligned base
    vec = 4 if t.dtype == torch.float32 else 8
    if t.stride(1) != 1 or (k > 1 and t.stride(0) % vec):
        raise ValueError(f"dw_cuda: {name} rows must be dense with a row stride that is a "
                         f"multiple of {vec} (strides {t.stride()})")
    if t.data_ptr() % (vec * t.element_size()):
        raise ValueError(f"dw_cuda: {name} data pointer breaks {vec}-element loads")
    return t.stride(0) if k > 1 else t.shape[1]


def dw_cuda(x2d: torch.Tensor, dy2d: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/dw.cu`` on x (K, Din) and dy (K, Dout), CUDA tensors of one
    dtype (fp32 or bf16), Din and Dout multiples of 128, rows dense with any
    aligned row stride: -> dW (Dout, Din) fp32, torch's weight layout (as
    :func:`dw_plain`). fp32 runs the SIMT kernel (row strides multiples of 4,
    16-byte aligned data); bf16 the tensor-core kernel, whose TMA copies need
    row strides that are multiples of 8 elements and a 16-byte aligned base.
    Raises on anything the kernel does not take (no copy is made). Each call
    adds one to ``dw_cuda.launches``, a bf16 one also to
    ``dw_cuda.launches_tc``."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    k = x2d.shape[0]
    ldx = _check(x2d, "x", k)
    ldy = _check(dy2d, "dy", k)
    if dy2d.device != x2d.device or dy2d.dtype != x2d.dtype:
        raise ValueError(f"dw_cuda: dy ({dy2d.dtype} on {dy2d.device}) must match x "
                         f"({x2d.dtype} on {x2d.device})")
    din, dout = x2d.shape[1], dy2d.shape[1]
    out = torch.empty((dout, din), dtype=torch.float32, device=x2d.device)
    sms = torch.cuda.get_device_properties(x2d.device).multi_processor_count
    tc = x2d.dtype == torch.bfloat16
    splits, chunk = k_splits(k, din, dout, sms, tc=tc)
    ws = (torch.empty((splits, dout, din), dtype=torch.float32, device=x2d.device)
          if splits > 1 else None)
    fn = _build.load("dw").mmu_dw
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(x2d.data_ptr(), ldx, dy2d.data_ptr(), ldy, out.data_ptr(),
             None if ws is None else ws.data_ptr(), k, din, dout, splits, chunk,
             _DTYPE_CODES[x2d.dtype], x2d.device.index or 0,
             torch.cuda.current_stream(x2d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dw kernel launch failed: CUDA error {err}")
    with _count_lock:
        dw_cuda.launches += 1
        dw_cuda.launches_tc += tc
    return out


dw_cuda.launches = 0
dw_cuda.launches_tc = 0


def weight_grad(x2d: torch.Tensor, dy2d: torch.Tensor) -> torch.Tensor:
    """dW (Dout, Din) fp32 of x (K, Din) and dy (K, Dout): the kernel for CUDA
    tensors, :func:`dw_plain` for CPU tensors."""
    if x2d.device.type == "cuda":
        return dw_cuda(x2d, dy2d)
    if x2d.device.type != "cpu":
        raise ValueError(f"weight_grad: unsupported device {x2d.device}")
    return dw_plain(x2d, dy2d)


class _LinearDW(torch.autograd.Function):
    """``F.linear(x, w)`` (no bias) whose dW runs on :func:`weight_grad`: the
    JAX package's ``dot_general_dw`` custom VJP (``dw.py:131-152``)."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return torch.nn.functional.linear(x, weight)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g, w).to(x.dtype)
        if ctx.needs_input_grad[1]:
            x2d = x.reshape(-1, x.shape[-1])
            if x2d.stride(-1) != 1:
                x2d = x2d.contiguous()
            g2d = g.reshape(-1, g.shape[-1]).to(x2d.dtype).contiguous()
            dw = weight_grad(x2d, g2d).to(w.dtype)
        return dx, dw


def linear_dw(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T`` (weight (Dout, Din), torch's layout) with the dW
    kernel in its backward."""
    return _LinearDW.apply(x, weight)
