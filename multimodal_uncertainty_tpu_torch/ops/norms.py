"""LayerNorm with fp32 internals: the plain version and the hand-written CUDA kernel.

Port of ``multimodal_uncertainty_tpu/ops/norms.py``. Inputs of any float
dtype are normalised in fp32 and cast back, the reference's fp16-safe
LayerNorm contract. :func:`layer_norm` is the plain version (the JAX
package's ``layer_norm_xla``), which every model runs by default and which
autograd differentiates. :func:`layer_norm_kernel` is the counterpart of
``layer_norm_pallas``: the kernel of ``csrc/layer_norm.cu`` on a CUDA tensor
(or it raises), the plain version on a CPU tensor. Like the Pallas kernel it
is forward only, and it raises where a gradient would be needed.
"""
from __future__ import annotations

import ctypes
import threading

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
LN_MAX_LANE_ELEMS = 32  # the register instances hold at most 32 elements a lane: D <= 1024
_count_lock = threading.Lock()


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def ln_instance(d: int, dtype: torch.dtype, ldx: int, aligned: bool) -> int:
    """The instance of ``csrc/layer_norm.cu`` for rows of ``d`` elements of
    ``dtype`` with row stride ``ldx``: the 16-byte vectors a lane holds when a
    warp holds the row in registers (d = 32 x nv x (4 fp32, 8 bf16), at most
    ``LN_MAX_LANE_ELEMS`` elements a lane, ldx a multiple of the vector and
    x, y, weight and bias 16-byte aligned: ``aligned``), else 0, the generic
    instance that takes any D, stride and alignment. At D = 768: 6 in fp32,
    3 in bf16."""
    vec = 128 // torch.finfo(dtype).bits
    if not aligned or ldx % vec or d % (32 * vec) or d // 32 > LN_MAX_LANE_ELEMS:
        return 0
    return d // (32 * vec)


def layer_norm_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Launch ``csrc/layer_norm.cu`` on x (..., D), fp32 or bf16 on the card,
    with fp32 (D,) weight and bias: -> y of x's shape and dtype. The rows of x
    may have any row stride that ``reshape(-1, D)`` keeps as a view (a slice
    such as x[:, 0] is read in place). :func:`ln_instance` picks the kernel's
    instance by D, dtype, stride and alignment: the row in registers, or the
    generic one. Raises on anything the kernel does not take. Each launch adds
    one to ``layer_norm_cuda.launches``."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"layer_norm_cuda: dtype {x.dtype} not supported")
    d = x.shape[-1]
    for t, name in ((weight, "weight"), (bias, "bias")):
        if (t.dtype != torch.float32 or tuple(t.shape) != (d,) or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"layer_norm_cuda: {name} must be contiguous float32 ({d},) on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    x2 = x.reshape(-1, d)
    if d > 1 and x2.stride(1) != 1:
        raise ValueError(f"layer_norm_cuda: rows must be dense (strides {x.stride()})")
    rows = x2.shape[0]
    ldx = x2.stride(0) if rows > 1 else d
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    nv = ln_instance(d, x.dtype, ldx, all(t.data_ptr() % 16 == 0 for t in (x2, y, weight, bias)))
    fn = _build.load("layer_norm").mmu_layer_norm
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(x2.data_ptr(), ldx, weight.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, d,
             eps, _DTYPE_CODES[x.dtype], nv, x.device.index or 0,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error {err}")
    with _count_lock:
        layer_norm_cuda.launches += 1
    return y


layer_norm_cuda.launches = 0


def layer_norm_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """The JAX package's ``layer_norm_pallas``: :func:`layer_norm_cuda` for a
    CUDA tensor, :func:`layer_norm` for a CPU tensor. Forward only: it raises
    when grad mode is on and x, weight or bias requires a gradient, as JAX
    cannot differentiate the Pallas kernel, rather than take the plain route."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError(
            "layer_norm_kernel is forward only (as the JAX package's layer_norm_pallas): "
            "run it under torch.no_grad(), or use layer_norm for a gradient"
        )
    return torch.ops.mmu.layer_norm(x, weight, bias, eps)


def _layer_norm_route(x, weight, bias, eps):
    if x.device.type == "cuda":
        return layer_norm_cuda(x, weight, bias, eps)
    if x.device.type != "cpu":
        raise ValueError(f"layer_norm_kernel: unsupported device {x.device}")
    return layer_norm(x, weight, bias, eps)


# the forward of layer_norm_kernel as one operator, ``torch.ops.mmu.layer_norm``: the kernel on
# a CUDA tensor, the plain version on a CPU one; its fake version gives the shape alone, so an
# exported program keeps the operator (registered as ``ops/attention.py``'s)
_LIB = torch.library.Library("mmu", "FRAGMENT")
_LIB.define("layer_norm(Tensor x, Tensor weight, Tensor bias, float eps) -> Tensor")
for _key in ("CPU", "CUDA"):
    _LIB.impl("layer_norm", lambda x, weight, bias, eps: _layer_norm_route(x, weight, bias, eps),
              _key)


@torch.library.register_fake("mmu::layer_norm")
def _(x, weight, bias, eps):
    return x.new_empty(x.shape)
