"""Masked multi-head attention: the hand-written CUDA kernel and its plain version.

Port of ``multimodal_uncertainty_tpu/ops/attention.py``'s forward entry points.
Tensors stay heads-last, ``(B, S, D)`` with ``D = n_head * Dh``, as in the JAX
package. Routing is by device only: a CUDA tensor launches the kernel of
``csrc/attention_fwd.cu`` (or raises), a CPU tensor takes the plain PyTorch
version. There is no other switch.

Precision: logits accumulate in fp32, the softmax is fp32, and the
probabilities are rounded to the input dtype before P.V, which accumulates in
fp32 (the JAX package's policy, ``ops/attention.py:13-19``).

Masking contract: ``key_mask`` is boolean ``(B, S)``, True = key kept. Masked
keys get the finite ``NEG_INF`` added before the softmax, so a row whose keys
are all masked averages V uniformly over all S keys.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def attention_fwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention: (B, S, D) x3 -> out (B, S, D), lse (B, H, S) fp32.

    The reference for the kernel (CPU tests, and the comparisons on the
    card); it mirrors the JAX package's ``sdpa_xla``."""
    b, s, d = q.shape
    dh = d // n_head

    def heads(t):
        return t.reshape(b, s, n_head, dh).transpose(1, 2).float()

    scores = torch.einsum("bhqd,bhkd->bhqk", heads(q), heads(k)) * (1.0 / dh**0.5)
    if key_mask is not None:
        bias = torch.zeros(key_mask.shape, dtype=torch.float32, device=q.device)
        bias.masked_fill_(~key_mask.bool(), NEG_INF)
        scores = scores + bias[:, None, None, :]
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhqk,bhkd->bhqd", probs, heads(v))
    return out.transpose(1, 2).reshape(b, s, d).to(q.dtype), lse


def _check_operand(t: torch.Tensor, name: str, shape, row_stride: int, dtype, device):
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    b, s, _ = shape
    if t.stride() != (s * row_stride, row_stride, 1):
        raise ValueError(
            f"{name}: rows must be dense with row stride {row_stride} "
            f"(strides {t.stride()})"
        )
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer must be 16-byte aligned")


def attention_fwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    *,
    n_head: int,
    with_lse: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch ``csrc/attention_fwd.cu`` on q, k, v (B, S, D) CUDA tensors.

    q, k and v may be column slices of one packed (B, S, 3D) tensor: they
    need only a common row stride, a last-dim stride of 1 and 16-byte
    alignment. Raises on anything the kernel does not take. Each launch adds
    one to ``attention_fwd_cuda.launches``."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    if q.device.type != "cuda":
        raise ValueError(f"attention_fwd_cuda needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"attention_fwd_cuda: dtype {q.dtype} not supported")
    b, s, d = q.shape
    if d % n_head or d // n_head not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"attention_fwd_cuda: head dim {d}/{n_head} not in {KERNEL_HEAD_DIMS}"
        )
    row_stride = q.stride(1)
    if row_stride % (16 // q.element_size()):
        raise ValueError(f"attention_fwd_cuda: row stride {row_stride} breaks 16-byte loads")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(t, name, (b, s, d), row_stride, q.dtype, q.device)
    if key_mask is not None:
        if (key_mask.dtype != torch.bool or tuple(key_mask.shape) != (b, s)
                or key_mask.device != q.device or not key_mask.is_contiguous()):
            raise ValueError(
                f"key_mask: expected contiguous bool ({b}, {s}) on {q.device}, got "
                f"{key_mask.dtype} {tuple(key_mask.shape)} on {key_mask.device}"
            )
    out = torch.empty((b, s, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, n_head, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b * s == 0:
        return out, lse
    fn = _build.load("attention_fwd").mmu_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), row_stride,
        None if key_mask is None else key_mask.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        b, s, n_head, d // n_head, _DTYPE_CODES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: CUDA error {err}")
    with _count_lock:
        attention_fwd_cuda.launches += 1
    return out, lse


attention_fwd_cuda.launches = 0


def _route(q, k, v, key_mask, n_head, with_lse):
    if q.device.type == "cuda":
        return attention_fwd_cuda(q, k, v, key_mask, n_head=n_head, with_lse=with_lse)
    if q.device.type == "cpu":
        out, lse = attention_fwd_plain(q, k, v, key_mask, n_head=n_head)
        return out, lse if with_lse else None
    raise ValueError(f"attention: unsupported device {q.device}")


def attention_qkv_packed(
    qkv: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> torch.Tensor:
    """Attention straight off a packed QKV projection: (B, S, 3D) -> (B, S, D).

    q | k | v are column slices of ``qkv`` (the torch MultiheadAttention
    in_proj order); the kernel reads them in place, with no split copies."""
    d3 = qkv.shape[-1]
    if d3 % (3 * n_head):
        raise ValueError(f"attention_qkv_packed: width {d3} does not split into 3 x {n_head} heads")
    d = d3 // 3
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    return _route(q, k, v, key_mask, n_head, with_lse=False)[0]


def attention_flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention on separate (B, S, D) q, k, v, with the per-row log-sum-exp:
    -> out (B, S, D), lse (B, H, S) fp32. The forward of the JAX package's
    flash kernels (``_sdpa_flash_fwd_impl``), without its S % 128 padding and
    with the LSE in plain layout instead of the TPU's lane-broadcast one."""
    if q.shape[-1] % n_head:
        raise ValueError(f"attention_flash_fwd: width {q.shape[-1]} not divisible by {n_head}")
    return _route(q, k, v, key_mask, n_head, with_lse=True)
