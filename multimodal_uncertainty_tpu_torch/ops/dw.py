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
weight's dtype (``dw.py:141-149``). fp32 inputs are multiplied on the tensor
cores as split fp32: each operand v is hi + lo, two TF32 values, and the
kernel sums lo·hi + hi·lo + hi·hi, within ~2^-21 of each fp32 product, where
one TF32 product would miss the fp32 gate.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

TILE = 128  # Din and Dout must be multiples of it (the output tile is 128 x 256, ragged in Din)
# per input dtype, the kernel's (Dout, Din) output tile, its K rows a stage (a split's K range is
# a multiple of it) and the rate of its products on one SM: fp32 issues three TF32 products a step
# (split fp32) at the 495 TFLOP/s TF32 rate, bf16 one at 989 (H100 SXM, 132 SMs). Both run one
# block an SM. k_splits weighs a split's work against its slab traffic at the memory rate.
KERNELS = {torch.float32: ((128, 256), 32, 495e12 / 3 / 132),
           torch.bfloat16: ((128, 256), 64, 989e12 / 132)}
_MAX_SPLITS = 32
_BYTES = 3.35e12
# fp32 at K <= SIMT_MAX_K (the pooler's and cls_fc's K = batch 32, MMBT's image embedding's 96)
# is a few 32-row stages of the split-fp32 kernel on 18 tiles of 768 x 768, most SMs idle; the
# small-K kernel's 64 x 64 tiles fill the card instead. In one call on an H100 it was ahead
# at K = 32-128 (768 x 768: 0.0049 against 0.0088 ms at K = 32, 0.0110 against
# 0.0169 at 128; 2048 x 768 at K = 96: 0.0120 against 0.0136), level at 192, behind at 256
SIMT_MAX_K = 128
_ROUTES = {"tc32": 0, "tc": 1, "simt": 2}  # mmu_dw's route codes
_count_lock = threading.Lock()


def dw_plain(x2d: torch.Tensor, dy2d: torch.Tensor) -> torch.Tensor:
    """(K, Din) x (K, Dout) -> (Dout, Din) fp32: ``dy2d.T @ x2d`` in fp32,
    torch's weight layout (the transpose of what ``_dw_pallas_2d`` returns).
    The CPU route and the reference the kernel is held to on the card."""
    return dy2d.float().t() @ x2d.float()


def k_splits(k: int, din: int, dout: int, sms: int,
             dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """(splits, k_chunk): K is cut into ``splits`` chunks of ``k_chunk`` rows
    for the kernel of ``dtype`` (one block an SM of a card with ``sms`` SMs).
    Chunks are multiples of the kernel's stage, and the count is the one that
    minimises the modelled time: waves of (tile, chunk) work units over the
    SMs at the kernel's rate, plus the slabs written and summed back at the
    memory rate, so the units come close to whole waves; ties go to fewer
    splits. The small-K kernel (route ``simt``) takes no split."""
    tile, stage, sm_flops = KERNELS[dtype]
    rows = max(k, 1)
    tiles = (dout // tile[0]) * -(-din // tile[1])
    best = None
    for want in range(1, min(_MAX_SPLITS, max(1, rows // stage)) + 1):
        chunk = -(-rows // want)
        chunk = -(-chunk // stage) * stage
        splits = -(-rows // chunk)
        waves = -(-tiles * splits // sms)
        seconds = waves * chunk * 2 * tile[0] * tile[1] / sm_flops
        if splits > 1:
            seconds += (2 * splits + 1) * dout * din * 4 / _BYTES
        if best is None or seconds < best[0]:
            best = (seconds, splits, chunk)
    return best[1], best[2]


def dw_route(k: int, dtype: torch.dtype) -> str:
    """The kernel of ``csrc/dw.cu`` that takes K rows of ``dtype``: ``tc`` (bf16
    on the tensor cores), ``tc32`` (fp32, split fp32 on the tensor cores) or,
    for fp32 at K <= ``SIMT_MAX_K``, ``simt`` (the small-K kernel on fp32
    FMAs)."""
    if dtype == torch.bfloat16:
        return "tc"
    return "simt" if k <= SIMT_MAX_K else "tc32"


def _check(t: torch.Tensor, name: str, k: int) -> int:
    """Device, dtype, shape and alignment of an operand; returns its row stride."""
    if t.device.type != "cuda":
        raise ValueError(f"dw_cuda: {name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in KERNELS:
        raise ValueError(f"dw_cuda: {name} dtype {t.dtype} not supported")
    if t.dim() != 2 or t.shape[0] != k or t.shape[1] % TILE:
        raise ValueError(f"dw_cuda: {name} must be ({k}, a multiple of {TILE}), "
                         f"got {tuple(t.shape)}")
    # the TMA copies rows of 16-byte multiples from a 16-byte aligned base
    vec = 16 // t.element_size()
    if t.stride(1) != 1 or (k > 1 and t.stride(0) % vec):
        raise ValueError(f"dw_cuda: {name} rows must be dense with a row stride that is a "
                         f"multiple of {vec} (strides {t.stride()})")
    if t.data_ptr() % (vec * t.element_size()):
        raise ValueError(f"dw_cuda: {name} data pointer is not 16-byte aligned")
    return t.stride(0) if k > 1 else t.shape[1]


def dw_cuda(x2d: torch.Tensor, dy2d: torch.Tensor, *,
            route: Optional[str] = None) -> torch.Tensor:
    """Launch ``csrc/dw.cu`` on x (K, Din) and dy (K, Dout), CUDA tensors of one
    dtype (fp32 or bf16), Din and Dout multiples of 128, rows dense with any
    aligned row stride: -> dW (Dout, Din) fp32, torch's weight layout (as
    :func:`dw_plain`). :func:`dw_route` picks the kernel: fp32 runs the
    split-fp32 tensor-core kernel (the small-K SIMT one at K <= ``SIMT_MAX_K``),
    bf16 the bf16 one; their loads need row strides of 16-byte multiples (4
    fp32 or 8 bf16 elements) and a 16-byte aligned base. ``route`` overrides
    that choice, for a benchmark to race the two fp32 kernels at one shape.
    Raises on anything the kernel does not take (no copy is made). Each call
    adds one to ``dw_cuda.launches`` and one to its route's count:
    ``launches_tc32``, ``launches_tc`` or ``launches_simt``."""
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
    route = route or dw_route(k, x2d.dtype)
    if (route == "tc") != (x2d.dtype == torch.bfloat16) or route not in ("tc", "tc32", "simt"):
        raise ValueError(f"dw_cuda: no {route} kernel for {x2d.dtype}")
    splits, chunk = ((1, max(k, 1)) if route == "simt"
                     else k_splits(k, din, dout, sms, x2d.dtype))
    ws = (torch.empty((splits, dout, din), dtype=torch.float32, device=x2d.device)
          if splits > 1 else None)
    fn = _build.load("dw").mmu_dw
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(x2d.data_ptr(), ldx, dy2d.data_ptr(), ldy, out.data_ptr(),
             None if ws is None else ws.data_ptr(), k, din, dout, splits, chunk,
             _ROUTES[route], x2d.device.index or 0,
             torch.cuda.current_stream(x2d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dw kernel launch failed: CUDA error {err}")
    with _count_lock:
        dw_cuda.launches += 1
        setattr(dw_cuda, f"launches_{route}", getattr(dw_cuda, f"launches_{route}") + 1)
    return out


dw_cuda.launches = 0
dw_cuda.launches_tc = 0  # bf16 launches
dw_cuda.launches_tc32 = 0  # fp32 launches on the split-fp32 kernel
dw_cuda.launches_simt = 0  # fp32 launches on the small-K kernel (K <= SIMT_MAX_K)


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
