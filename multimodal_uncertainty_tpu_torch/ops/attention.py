"""Masked multi-head attention: the hand-written CUDA kernels and their plain versions.

Port of ``multimodal_uncertainty_tpu/ops/attention.py``'s heads-last entry
points with their backward. Tensors stay heads-last, ``(B, S, D)`` with
``D = n_head * Dh``, as in the JAX package. Routing is by device only: a CUDA
tensor launches the kernels of ``csrc/attention_fwd*.cu`` and
``csrc/attention_bwd*.cu`` (or raises), a CPU tensor takes the plain PyTorch
versions. There is no other switch. Both routes run through the same
``torch.autograd.Function``s, so a gradient reaches the inputs on the card as
it does on the CPU.

Precision: logits accumulate in fp32, the softmax is fp32, and the
probabilities are rounded to the input dtype before P.V, which accumulates in
fp32 (the JAX package's policy, ``ops/attention.py:13-19``). The backward
rounds P and dS to the input dtype before their products, as the JAX
package's ``_attn_bwd_kernel_hl`` does.

Masking contract: ``key_mask`` is boolean ``(B, S)``, True = key kept. Masked
keys get the finite ``NEG_INF`` added before the softmax, so a row whose keys
are all masked averages V uniformly over all S keys, and its gradient is that
of the uniform average (the JAX package's K1 backward and XLA autodiff; its
flash backward writes zeros there instead).

Head dims: the kernels have instances at Dh 24, 32, 48, 64, 96, 128, 192,
256, 384 and 768, so FLAVA fusion (D=768) runs on them at 32, 24, 16, 12, 8,
6, 4, 3, 2 and 1 heads. Where the JAX package runs Dh 24, 48, 96 and 192 on
its heads-first kernel (``_sdpa_pallas``, after a relayout to (B, H, S, Dh)),
the port reads the heads-last rows in place as for every other head dim.
A head dim with no instance raises on the card; the CLIs reject such a head
count before any data loads (:func:`check_kernel_heads`).

Attention-probability dropout (BERT's training regulariser,
``attention_heads_last_dropout``): a uint8 ``(B, H, S, S)`` keep mask with
P(keep) = 1 - rate is drawn outside the kernels from an explicit
``torch.Generator`` and saved for the backward, as the JAX package draws its
mask outside its K5 kernels. The softmax is normalised before dropout; kept
probabilities are scaled by 1 / (1 - rate).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import torch

NEG_INF = -1e30
# the sources that hold each head dim's plain instances, the same in both
# directions (the dropout ones are in the first): csrc/attention_fwd<suffix>.cu,
# csrc/attention_bwd<suffix>.cu
_SUFFIX = {**{dh: "" for dh in (32, 64, 128)}, **{dh: "_k6" for dh in (24, 48, 96, 192)},
           256: "_256", **{dh: "_wide" for dh in (384, 768)}}
# head dims each kernel has an instance for (Dh=32 serves the tiny BERT
# configs; the dropout instances are BERT's head dims)
KERNEL_HEAD_DIMS = {"attention_fwd_cuda": tuple(sorted(_SUFFIX)),
                    "attention_bwd_cuda": tuple(sorted(_SUFFIX)),
                    "attention_fwd_dropout_cuda": (32, 64),
                    "attention_bwd_dropout_cuda": (32, 64)}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the tensor-core forward and backward, which take every bf16 launch (at the
# head dims of TC_FWD_DIMS / TC_BWD_DIMS without dropout, and with dropout at
# those of TC_FWD_DROPOUT_DIMS / TC_BWD_DROPOUT_DIMS):
# csrc/attention_{fwd,bwd}_tc<suffix>.cu, one source a head dim and direction,
# the suffix of _TC_SUFFIX (not _SUFFIX's, which names one source for Dh 24, 48,
# 96 and 192); the fp32 launches take the instances above. Both directions
# have a source at every head dim of D=768's head counts.
TC_FWD_SOURCE = "attention_fwd_tc"
TC_BWD_SOURCE = "attention_bwd_tc"
_TC_SUFFIX = {24: "_24", 32: "_32", 48: "_48", 64: "", 96: "_k6", 128: "_128", 192: "_192",
              256: "_256", 384: "_384", 768: "_768"}
TC_FWD_DIMS = TC_BWD_DIMS = tuple(sorted(_TC_SUFFIX))
# BERT-base's and the tiny BERT's
TC_FWD_DROPOUT_DIMS = TC_BWD_DROPOUT_DIMS = (32, 64)
# the forward's tensor-core sources by name: "attention_fwd_tc32" starts with
# TC_FWD_SOURCE too, so the route is told by membership, never by prefix
TC_FWD_SOURCES = frozenset(TC_FWD_SOURCE + _TC_SUFFIX[dh] for dh in TC_FWD_DIMS)
TC_BWD_SOURCES = frozenset(TC_BWD_SOURCE + _TC_SUFFIX[dh] for dh in TC_BWD_DIMS)
# the split-fp32 tensor-core forward (fp32 at Dh 24-192, with and without
# dropout): csrc/attention_fwd_tc32<suffix>.cu, the suffix of _SUFFIX
TC32_FWD_SOURCE = "attention_fwd_tc32"
_count_lock = threading.Lock()


def _heads(t: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, S, D) -> (B, H, S, Dh) in fp32."""
    b, s, d = t.shape
    return t.reshape(b, s, n_head, d // n_head).transpose(1, 2).float()


def _merge_heads(t: torch.Tensor, dtype) -> torch.Tensor:
    """(B, H, S, Dh) -> (B, S, D) in ``dtype``."""
    b, h, s, dh = t.shape
    return t.transpose(1, 2).reshape(b, s, h * dh).to(dtype)


def _scores(q, k, key_mask, n_head) -> torch.Tensor:
    """Scaled, masked fp32 logits (B, H, S, S)."""
    dh = q.shape[-1] // n_head
    scores = torch.einsum("bhqd,bhkd->bhqk", _heads(q, n_head), _heads(k, n_head)) * (
        1.0 / dh**0.5)
    if key_mask is not None:
        bias = torch.zeros(key_mask.shape, dtype=torch.float32, device=q.device)
        bias.masked_fill_(~key_mask.bool(), NEG_INF)
        scores = scores + bias[:, None, None, :]
    return scores


def attention_fwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention: (B, S, D) x3 -> out (B, S, D), lse (B, H, S) fp32.

    The reference for the forward kernel (CPU tests, and the comparisons on
    the card); it mirrors the JAX package's ``sdpa_xla``."""
    scores = _scores(q, k, key_mask, n_head)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhqk,bhkd->bhqd", probs, _heads(v, n_head))
    return _merge_heads(out, q.dtype), lse


def attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    dout: torch.Tensor,
    *,
    n_head: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention backward: dq, dk, dv (B, S, D) in the input dtype.

    Recomputes P in fp32, then dV = P^T dO, dP = dO V^T,
    dS = P * (dP - rowsum(dP * P)), dQ = dS K scale, dK = dS^T Q scale, with P
    and dS rounded to the input dtype before their products, as the JAX
    package's ``_attn_bwd_kernel_hl`` does. The reference for the backward
    kernel; the main path never calls it on the card."""
    dh = q.shape[-1] // n_head
    scale = 1.0 / dh**0.5
    dtype = q.dtype
    p = torch.softmax(_scores(q, k, key_mask, n_head), dim=-1)
    g, vh = _heads(dout, n_head), _heads(v, n_head)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dtype).float(), g)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, vh)
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, _heads(k, n_head)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _heads(q, n_head)) * scale
    return _merge_heads(dq, dtype), _merge_heads(dk, dtype), _merge_heads(dv, dtype)


def attention_probs_dropout(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    *,
    n_head: int,
    rate: float,
    keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch attention with dropout on the probabilities: (B, S, D) x3
    -> (B, S, D). The JAX package's ``attention_probs_dropout`` with the keep
    mask passed in (uint8 or bool ``(B, H, S, S)``) instead of drawn from a
    key: P = softmax in fp32, then ``where(keep, P / (1 - rate), 0)``, rounded
    to the input dtype before P.V. ``rate == 0`` is the plain forward. The
    reference for the dropout forward kernel."""
    scores = _scores(q, k, key_mask, n_head)
    probs = torch.softmax(scores, dim=-1)
    if rate > 0.0:
        if keep is None:
            raise ValueError("attention_probs_dropout: rate > 0 needs a keep mask")
        probs = torch.where(keep.bool(), probs / (1.0 - rate), 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(), _heads(v, n_head))
    return _merge_heads(out, q.dtype)


def attention_bwd_dropout_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    keep: torch.Tensor,
    dout: torch.Tensor,
    *,
    n_head: int,
    rate: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of :func:`attention_probs_dropout`: dq, dk, dv.

    The JAX package's ``_attn_bwd_kernel_hl_drop``: Pd = where(keep, P /
    (1 - rate), 0), dV = Pd^T dO, dP = where(keep, dO V^T / (1 - rate), 0),
    dS = P * (dP - rowsum(dP * P)), dQ = dS K scale, dK = dS^T Q scale, with
    Pd and dS rounded to the input dtype before their products. The reference
    for the dropout backward kernel."""
    dh = q.shape[-1] // n_head
    scale = 1.0 / dh**0.5
    inv_keep = 1.0 / (1.0 - rate)
    dtype = q.dtype
    kept = keep.bool()
    p = torch.softmax(_scores(q, k, key_mask, n_head), dim=-1)
    g, vh = _heads(dout, n_head), _heads(v, n_head)
    pd = torch.where(kept, p * inv_keep, 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", pd.to(dtype).float(), g)
    dp = torch.where(kept, torch.einsum("bhqd,bhkd->bhqk", g, vh) * inv_keep, 0.0)
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, _heads(k, n_head)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _heads(q, n_head)) * scale
    return _merge_heads(dq, dtype), _merge_heads(dk, dtype), _merge_heads(dv, dtype)


def draw_keep_mask(shape, rate: float, *, generator: Optional[torch.Generator] = None,
                   device=None) -> torch.Tensor:
    """A uint8 dropout keep mask of ``shape`` with P(keep) = 1 - rate, drawn
    from ``generator`` (the device's default generator when None)."""
    return (torch.rand(shape, generator=generator, device=device) < 1.0 - rate).view(
        torch.uint8)


def check_kernel_heads(width: int, n_head: int, device) -> None:
    """Raise ValueError when attention of ``n_head`` heads over ``width``
    would need a kernel instance the card does not have. Only a CUDA
    ``device`` is checked: the plain CPU route takes any head dim. The CLIs
    call it before they load any data."""
    if torch.device(device).type != "cuda":
        return
    dims = KERNEL_HEAD_DIMS["attention_fwd_cuda"]
    if width % n_head or width // n_head not in dims:
        heads = [width // dh for dh in dims if width % dh == 0]
        raise ValueError(
            f"{n_head} attention heads over width {width}: head dim "
            f"{width / n_head:g} has no kernel on the card, which takes head dims "
            f"{list(dims)} (at width {width}: {heads} heads); run it with "
            f"--device cpu, or choose one of those head counts"
        )


def _count(wrapper, dh: int) -> None:
    """One launch of ``wrapper``'s kernel at head dim ``dh``: its ``launches``
    total and its ``launches_by_dh`` entry."""
    with _count_lock:
        wrapper.launches += 1
        wrapper.launches_by_dh[dh] = wrapper.launches_by_dh.get(dh, 0) + 1


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


def _check_qkv(q, k, v, n_head, who: str) -> int:
    """Device, dtype, head dim, strides and alignment of q, k, v for a kernel;
    returns their common row stride."""
    if q.device.type != "cuda":
        raise ValueError(f"{who} needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{who}: dtype {q.dtype} not supported")
    b, s, d = q.shape
    if d % n_head or d // n_head not in KERNEL_HEAD_DIMS[who]:
        raise ValueError(f"{who}: head dim {d / n_head:g} ({d}/{n_head}) has no instance; "
                         f"the kernel takes {KERNEL_HEAD_DIMS[who]}")
    row_stride = q.stride(1)
    if row_stride % (16 // q.element_size()):
        raise ValueError(f"{who}: row stride {row_stride} breaks 16-byte loads")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(t, name, (b, s, d), row_stride, q.dtype, q.device)
    return row_stride


def _check_mask(key_mask, b: int, s: int, device) -> None:
    if key_mask is None:
        return
    if (key_mask.dtype != torch.bool or tuple(key_mask.shape) != (b, s)
            or key_mask.device != device or not key_mask.is_contiguous()):
        raise ValueError(
            f"key_mask: expected contiguous bool ({b}, {s}) on {device}, got "
            f"{key_mask.dtype} {tuple(key_mask.shape)} on {key_mask.device}"
        )


def _check_keep(keep, rate: float, b: int, h: int, s: int, device) -> float:
    """Validates a dropout keep mask; returns 1 / (1 - rate)."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must lie in (0, 1), got {rate}")
    if (keep.dtype != torch.uint8 or tuple(keep.shape) != (b, h, s, s)
            or keep.device != device or not keep.is_contiguous()):
        raise ValueError(
            f"keep: expected contiguous uint8 ({b}, {h}, {s}, {s}) on {device}, got "
            f"{keep.dtype} {tuple(keep.shape)} on {keep.device}"
        )
    return 1.0 / (1.0 - rate)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _tc_source(prefix: str, dims, dh: int, dropout: bool, who: str) -> str:
    """The bf16 tensor-core source of ``prefix`` at ``dh``; raises ValueError
    where it has no instance (``dims``: the head dims of the launch's kind)."""
    if dh not in dims:
        raise ValueError(f"bf16 attention {who}{' with dropout' if dropout else ''}: no instance "
                         f"at Dh {dh}; the tensor-core sources take {dims}")
    return prefix + _TC_SUFFIX[dh]


def fwd_source(dtype, dh: int, dropout: bool) -> str:
    """The CUDA source whose forward a launch runs. Every bf16 launch takes
    the tensor-core kernel of ``csrc/attention_fwd_tc.cuh``, one source a head
    dim (``csrc/attention_fwd_tc{_24,_32,_48,,_k6,_128,_192,_256}.cu``; with
    dropout at Dh 32 and 64, :data:`TC_FWD_DROPOUT_DIMS`), or at Dh 384 and
    768 that of ``csrc/attention_fwd_tc_wide.cuh`` (``csrc/attention_fwd_tc_
    {384,768}.cu``; :data:`TC_FWD_DIMS`); a bf16 head dim with no instance
    raises ValueError. fp32 takes the split-fp32 tensor-core kernels of
    ``csrc/attention_fwd_tc32.cuh`` at Dh 24-192, with or without dropout
    (``csrc/attention_fwd_tc32.cu`` at Dh 32, 64 and 128,
    ``csrc/attention_fwd_tc32_k6.cu`` at 24, 48, 96 and 192), the micro-tile
    kernel of ``csrc/attention_fwd_wide.cuh`` at Dh 256
    (``csrc/attention_fwd_256.cu``) and on clusters at Dh 384 and 768
    (``csrc/attention_fwd_wide.cu``)."""
    if dtype == torch.bfloat16:
        return _tc_source(TC_FWD_SOURCE, TC_FWD_DROPOUT_DIMS if dropout else TC_FWD_DIMS, dh,
                          dropout, "forward")
    if dh <= 192:
        return TC32_FWD_SOURCE + _SUFFIX[dh]
    return "attention_fwd" + _SUFFIX[dh]


def _count_route(wrapper, dtype, dh: int, dropout: bool) -> None:
    """One launch on a tensor-core forward: ``wrapper.launches_tc`` (bf16)
    or ``wrapper.launches_tc32`` (split fp32), if the launch took one."""
    source = fwd_source(dtype, dh, dropout)
    route = ("launches_tc" if source in TC_FWD_SOURCES
             else "launches_tc32" if source.startswith(TC32_FWD_SOURCE) else None)
    if route is not None:
        with _count_lock:
            setattr(wrapper, route, getattr(wrapper, route) + 1)


def _launch_fwd(q, k, v, key_mask, keep, rate, n_head, who):
    """One launch of the forward (:func:`fwd_source` picks the source);
    ``keep`` None = no dropout."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    row_stride = _check_qkv(q, k, v, n_head, who)
    b, s, d = q.shape
    _check_mask(key_mask, b, s, q.device)
    inv_keep = 1.0 if keep is None else _check_keep(keep, rate, b, n_head, s, q.device)
    out = torch.empty((b, s, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n_head, s), dtype=torch.float32, device=q.device)
    if b * s == 0:
        return out, lse
    source = fwd_source(q.dtype, d // n_head, keep is not None)
    if source in TC_FWD_SOURCES:
        # with dropout, scratch for the keep mask's bits by query rows
        keep_words = None if keep is None else torch.empty(
            (b, n_head, s, (s + 31) // 32), dtype=torch.int32, device=q.device)
        fn = _build.load(source).mmu_attention_fwd_tc
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
                       + [ctypes.c_float] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), row_stride, _ptr(key_mask), _ptr(keep),
            inv_keep, _ptr(keep_words), out.data_ptr(), lse.data_ptr(), b, s, n_head,
            q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"{source} kernel launch failed: CUDA error {err}")
        return out, lse
    fn = _build.load(source).mmu_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
                   + [ctypes.c_float] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), row_stride, _ptr(key_mask), _ptr(keep),
        inv_keep, out.data_ptr(), lse.data_ptr(),
        b, s, n_head, d // n_head, _DTYPE_CODES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: CUDA error {err}")
    return out, lse


def bwd_source(dtype, dh: int, dropout: bool) -> str:
    """The CUDA source whose backward a launch runs. Every bf16 launch takes
    the tensor-core kernels of ``csrc/attention_bwd_tc.cuh``, one source a
    head dim (``csrc/attention_bwd_tc{_24,_32,_48,,_k6,_128,_192,_256}.cu``;
    with dropout at Dh 32 and 64, :data:`TC_BWD_DROPOUT_DIMS`), or at Dh 384
    and 768 those of ``csrc/attention_bwd_tc_wide.cuh`` on clusters
    (``csrc/attention_bwd_tc_{384,768}.cu``; :data:`TC_BWD_DIMS`); a bf16
    head dim with no instance raises ValueError. fp32 takes the micro-tile
    kernel of ``csrc/attention_bwd_wide.cuh``: one block a row tile at Dh
    24-256 (``csrc/attention_bwd{,_k6,_256}.cu``, the dropout instances in
    the first), clusters at Dh 384 and 768 (``csrc/attention_bwd_wide.cu``)."""
    if dtype == torch.bfloat16:
        return _tc_source(TC_BWD_SOURCE, TC_BWD_DROPOUT_DIMS if dropout else TC_BWD_DIMS, dh,
                          dropout, "backward")
    return "attention_bwd" + _SUFFIX[dh]


def _launch_bwd(q, k, v, key_mask, keep, rate, out, lse, dout, n_head, grads, who):
    """One launch of the backward (:func:`bwd_source` picks the source);
    ``keep`` None = no dropout."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    row_stride = _check_qkv(q, k, v, n_head, who)
    b, s, d = q.shape
    _check_mask(key_mask, b, s, q.device)
    inv_keep = 1.0 if keep is None else _check_keep(keep, rate, b, n_head, s, q.device)
    for t, name in ((out, "out"), (dout, "dout")):
        _check_operand(t, name, (b, s, d), d, q.dtype, q.device)
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, n_head, s)
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(
            f"lse: expected contiguous float32 ({b}, {n_head}, {s}) on {q.device}, got "
            f"{lse.dtype} {tuple(lse.shape)} on {lse.device}"
        )
    if grads is None:
        grads = tuple(torch.empty((b, s, d), dtype=q.dtype, device=q.device) for _ in range(3))
    dq, dk, dv = grads
    grad_stride = dq.stride(1)
    for t, name in ((dq, "dq"), (dk, "dk"), (dv, "dv")):
        _check_operand(t, name, (b, s, d), grad_stride, q.dtype, q.device)
    if b * s == 0:
        return dq, dk, dv
    delta = torch.empty((b, n_head, s), dtype=torch.float32, device=q.device)
    source = bwd_source(q.dtype, d // n_head, keep is not None)
    if source in TC_BWD_SOURCES:
        # with dropout, scratch for the keep mask's bits (by query rows, then by key columns)
        keep_words = None if keep is None else torch.empty(
            (2, b, n_head, s, (s + 31) // 32), dtype=torch.int32, device=q.device)
        fn = _build.load(source).mmu_attention_bwd_tc
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
                       + [ctypes.c_float] + [ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), row_stride, _ptr(key_mask), _ptr(keep),
            inv_keep, _ptr(keep_words), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), grad_stride,
            b, s, n_head, q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"{source} kernel launch failed: CUDA error {err}")
        return dq, dk, dv
    fn = _build.load(source).mmu_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
                   + [ctypes.c_float] + [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), row_stride, _ptr(key_mask), _ptr(keep),
        inv_keep, out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), grad_stride,
        b, s, n_head, d // n_head, _DTYPE_CODES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"attention_bwd kernel launch failed: CUDA error {err}")
    return dq, dk, dv


def attention_fwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the attention forward kernel on q, k, v (B, S, D) CUDA tensors:
    -> out (B, S, D), lse (B, H, S) fp32 (the backward rebuilds P from it).

    q, k and v may be column slices of one packed (B, S, 3D) tensor: they
    need only a common row stride, a last-dim stride of 1 and 16-byte
    alignment. Raises on anything the kernel does not take. bf16 at Dh
    24-256 runs the tensor-core kernel of ``csrc/attention_fwd_tc.cuh``, at
    384 and 768 that of ``csrc/attention_fwd_tc_wide.cuh``, fp32 at Dh 24-192
    the split-fp32 kernels of ``csrc/attention_fwd_tc32.cuh``, fp32 at Dh
    256, 384 and 768 the micro-tile kernel of ``csrc/attention_fwd_wide.cuh``
    (:func:`fwd_source`). Each launch adds one to
    ``attention_fwd_cuda.launches`` and to its head dim's entry of
    ``attention_fwd_cuda.launches_by_dh``, a bf16 tensor-core one also to
    ``attention_fwd_cuda.launches_tc``, a split-fp32 one to
    ``attention_fwd_cuda.launches_tc32``."""
    out, lse = _launch_fwd(q, k, v, key_mask, None, 0.0, n_head, "attention_fwd_cuda")
    dh = q.shape[-1] // n_head
    _count(attention_fwd_cuda, dh)
    _count_route(attention_fwd_cuda, q.dtype, dh, False)
    return out, lse


attention_fwd_cuda.launches = 0
attention_fwd_cuda.launches_by_dh = {}
attention_fwd_cuda.launches_tc = 0
attention_fwd_cuda.launches_tc32 = 0


def attention_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    n_head: int,
    grads: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the attention backward kernels: dq, dk, dv of attention on CUDA tensors.

    q, k, v follow the forward's rules (a common row stride, so slices of the
    packed projection are read in place). ``out`` and ``dout`` are dense
    (B, S, D), ``lse`` the forward's (B, H, S) fp32 log-sum-exp. ``grads``,
    if given, are the three (B, S, D) outputs with a common row stride, e.g.
    the column slices of one (B, S, 3D) gradient, written in place; by
    default they are fresh tensors. Raises on anything the kernel does not
    take. bf16 at Dh 24-256 runs the tensor-core kernels of
    ``csrc/attention_bwd_tc.cuh``, at 384 and 768 those of
    ``csrc/attention_bwd_tc_wide.cuh``, fp32 the micro-tile kernel of
    ``csrc/attention_bwd_wide.cuh`` (:func:`bwd_source`). Each launch adds one to
    ``attention_bwd_cuda.launches`` and to its head dim's entry of
    ``attention_bwd_cuda.launches_by_dh``, a tensor-core one also to
    ``attention_bwd_cuda.launches_tc``."""
    grads = _launch_bwd(q, k, v, key_mask, None, 0.0, out, lse, dout, n_head, grads,
                        "attention_bwd_cuda")
    dh = q.shape[-1] // n_head
    _count(attention_bwd_cuda, dh)
    if bwd_source(q.dtype, dh, False) in TC_BWD_SOURCES:
        with _count_lock:
            attention_bwd_cuda.launches_tc += 1
    return grads


attention_bwd_cuda.launches = 0
attention_bwd_cuda.launches_by_dh = {}
attention_bwd_cuda.launches_tc = 0


def attention_fwd_dropout_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    keep: torch.Tensor,
    *,
    n_head: int,
    rate: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dropout instance of the forward (K5 fwd; fp32 on the
    split-fp32 kernel of ``csrc/attention_fwd_tc32.cu``, bf16 on the
    tensor-core kernel of ``csrc/attention_fwd_tc.cu`` at Dh 64 and
    ``csrc/attention_fwd_tc_32.cu`` at 32): -> out (B, S, D), lse (B, H, S) fp32 of the
    un-dropped softmax. ``keep`` is the contiguous uint8 (B, H, S, S) mask;
    q, k, v follow :func:`attention_fwd_cuda`'s rules. Each launch adds one
    to ``attention_fwd_dropout_cuda.launches``, a split-fp32 one also to
    ``attention_fwd_dropout_cuda.launches_tc32``, a bf16 tensor-core one to
    ``attention_fwd_dropout_cuda.launches_tc``."""
    out, lse = _launch_fwd(q, k, v, key_mask, keep, rate, n_head, "attention_fwd_dropout_cuda")
    dh = q.shape[-1] // n_head
    _count(attention_fwd_dropout_cuda, dh)
    _count_route(attention_fwd_dropout_cuda, q.dtype, dh, True)
    return out, lse


attention_fwd_dropout_cuda.launches = 0
attention_fwd_dropout_cuda.launches_by_dh = {}
attention_fwd_dropout_cuda.launches_tc = 0
attention_fwd_dropout_cuda.launches_tc32 = 0


def attention_bwd_dropout_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    keep: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    n_head: int,
    rate: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the dropout backward (K5 bwd; bf16 on the tensor-core kernels
    of ``csrc/attention_bwd_tc.cu`` at Dh 64 and ``csrc/attention_bwd_tc_32.cu``
    at 32, fp32 on the instances of ``csrc/attention_bwd.cu``): dq, dk, dv
    through the forward's ``keep`` mask, from its out and lse. Each launch adds one to
    ``attention_bwd_dropout_cuda.launches``, a tensor-core one also to
    ``attention_bwd_dropout_cuda.launches_tc``."""
    grads = _launch_bwd(q, k, v, key_mask, keep, rate, out, lse, dout, n_head, None,
                        "attention_bwd_dropout_cuda")
    dh = q.shape[-1] // n_head
    _count(attention_bwd_dropout_cuda, dh)
    if bwd_source(q.dtype, dh, True) in TC_BWD_SOURCES:
        with _count_lock:
            attention_bwd_dropout_cuda.launches_tc += 1
    return grads


attention_bwd_dropout_cuda.launches = 0
attention_bwd_dropout_cuda.launches_by_dh = {}
attention_bwd_dropout_cuda.launches_tc = 0


def _device_of(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"attention: unsupported device {t.device}")
    return t.device.type


def _fwd_route(q, k, v, key_mask, n_head):
    if _device_of(q) == "cuda":
        return attention_fwd_cuda(q, k, v, key_mask, n_head=n_head)
    return attention_fwd_plain(q, k, v, key_mask, n_head=n_head)


# the attention forward as one operator, ``torch.ops.mmu.attention_fwd``, on the dispatcher's
# plain registration API: ``torch.library.custom_op`` would import ~800 modules at its first call
# (seconds in every process) and add ~30 µs a call
_LIB = torch.library.Library("mmu", "FRAGMENT")
_LIB.define("attention_fwd(Tensor q, Tensor k, Tensor v, Tensor? key_mask, int n_head) "
            "-> (Tensor, Tensor)")
for _key in ("CPU", "CUDA"):
    _LIB.impl("attention_fwd", lambda q, k, v, key_mask, n_head: _fwd_route(
        q, k, v, key_mask, n_head), _key)


@torch.library.register_fake("mmu::attention_fwd")
def _(q, k, v, key_mask, n_head):
    b, s, d = q.shape
    return q.new_empty((b, s, d)), q.new_empty((b, n_head, s), dtype=torch.float32)


def attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_mask: Optional[torch.Tensor], n_head: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention forward as one operator, ``torch.ops.mmu.attention_fwd``:
    q, k, v (B, S, D) -> out (B, S, D), lse (B, H, S) fp32. Its body is
    :func:`_fwd_route`: the kernel on a CUDA tensor (counted as every launch
    is), the plain version on a CPU tensor. Every forward of the model paths
    (the autograd Functions below, live and under ``torch.export``) reaches
    the kernels through it; its fake version gives the shapes alone, so an
    exported program keeps the operator with a symbolic batch and sequence."""
    return torch.ops.mmu.attention_fwd(q, k, v, key_mask, n_head)


def _bwd_route(q, k, v, key_mask, out, lse, dout, n_head, grads=None):
    if _device_of(q) == "cuda":
        return attention_bwd_cuda(q, k, v, key_mask, out, lse, dout, n_head=n_head,
                                  grads=grads)
    result = attention_bwd_plain(q, k, v, key_mask, dout, n_head=n_head)
    if grads is None:
        return result
    for dst, src in zip(grads, result):
        dst.copy_(src)
    return tuple(grads)


def _split(qkv: torch.Tensor, n_head: int):
    d3 = qkv.shape[-1]
    if d3 % (3 * n_head):
        raise ValueError(f"attention_qkv_packed: width {d3} does not split into 3 x {n_head} heads")
    d = d3 // 3
    return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]


class _PackedAttention(torch.autograd.Function):
    """K1 of the JAX package (``_sdpa_pallas_packed``): the forward reads q | k
    | v in place off the packed projection; the backward writes dq | dk | dv
    straight into the three column slices of one (B, S, 3D) gradient."""

    @staticmethod
    def forward(ctx, qkv, key_mask, n_head):
        q, k, v = _split(qkv, n_head)
        out, lse = attention_fwd_op(q, k, v, key_mask, n_head)
        ctx.save_for_backward(qkv, key_mask, out, lse)
        ctx.n_head = n_head
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, key_mask, out, lse = ctx.saved_tensors
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        q, k, v = _split(qkv, ctx.n_head)
        _bwd_route(q, k, v, key_mask, out, lse, dout.contiguous(), ctx.n_head,
                   grads=_split(dqkv, ctx.n_head))
        return dqkv, None, None


class _Attention(torch.autograd.Function):
    """K3 of the JAX package (``_sdpa_pallas_flash``) on separate q, k, v: the
    forward also returns the LSE (not differentiable); the backward rebuilds P
    from it."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, n_head):
        out, lse = attention_fwd_op(q, k, v, key_mask, n_head)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.n_head = n_head
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_route(q, k, v, key_mask, out, lse, dout.contiguous(), ctx.n_head)
        return dq, dk, dv, None, None


class _DropoutAttention(torch.autograd.Function):
    """K5 of the JAX package (``_sdpa_pallas_hl_drop``): attention on separate
    q, k, v with dropout on the probabilities from a given keep mask, which is
    saved for the backward so both passes see the same draw."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, keep, n_head, rate):
        if _device_of(q) == "cuda":
            out, lse = attention_fwd_dropout_cuda(q, k, v, key_mask, keep, n_head=n_head,
                                                  rate=rate)
        else:
            out, lse = attention_probs_dropout(q, k, v, key_mask, n_head=n_head, rate=rate,
                                               keep=keep), None
        ctx.save_for_backward(q, k, v, key_mask, keep, out, lse)
        ctx.n_head, ctx.rate = n_head, rate
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, keep, out, lse = ctx.saved_tensors
        if _device_of(q) == "cuda":
            grads = attention_bwd_dropout_cuda(q, k, v, key_mask, keep, out, lse,
                                               dout.contiguous(), n_head=ctx.n_head,
                                               rate=ctx.rate)
        else:
            grads = attention_bwd_dropout_plain(q, k, v, key_mask, keep, dout,
                                                n_head=ctx.n_head, rate=ctx.rate)
        return (*grads, None, None, None, None)


def attention_qkv_packed(
    qkv: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> torch.Tensor:
    """Attention straight off a packed QKV projection: (B, S, 3D) -> (B, S, D).

    q | k | v are column slices of ``qkv`` (the torch MultiheadAttention
    in_proj order); the kernels read them in place, with no split copies, and
    the gradient comes back as one (B, S, 3D) tensor."""
    _split(qkv, n_head)  # validates the width before anything is launched
    _device_of(qkv)
    return _PackedAttention.apply(qkv, key_mask, n_head)


def attention_heads_last(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> torch.Tensor:
    """Attention on separate heads-last q, k, v: (B, S, D) x3 -> (B, S, D).

    The JAX package's ``attention_heads_last`` (BERT's self-attention), whose
    TPU route is the whole-sequence kernel K2 (``_sdpa_hl_fwd_impl``) and,
    once the score plane outgrows VMEM, the flash kernels. Here one kernel
    takes every S, so there is no switch: the three dense projection outputs
    go to :func:`attention_flash_fwd`'s Function and the LSE is dropped."""
    if q.shape[-1] % n_head:
        raise ValueError(f"attention_heads_last: width {q.shape[-1]} not divisible by {n_head}")
    _device_of(q)
    return _Attention.apply(q, k, v, key_mask, n_head)[0]


def attention_heads_last_dropout(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    *,
    n_head: int,
    rate: float,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """:func:`attention_heads_last` with dropout on the attention
    probabilities (the JAX package's ``attention_heads_last_dropout``, BERT's
    ``attention_probs_dropout_prob`` in training). The uint8 (B, H, S, S)
    keep mask is drawn from ``generator`` on q's device, then
    :func:`attention_heads_last_dropout_keep` runs it. ``rate == 0`` is
    :func:`attention_heads_last` unchanged. The JAX package takes its K5
    kernel only where the whole sequence fits VMEM and its XLA route
    elsewhere, from the same mask; here one kernel takes every S."""
    if rate <= 0.0:
        return attention_heads_last(q, k, v, key_mask, n_head=n_head)
    b, s, _ = q.shape
    keep = draw_keep_mask((b, n_head, s, s), rate, generator=generator, device=q.device)
    return attention_heads_last_dropout_keep(q, k, v, key_mask, keep, n_head=n_head, rate=rate)


def attention_heads_last_dropout_keep(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    keep: torch.Tensor,
    *,
    n_head: int,
    rate: float,
) -> torch.Tensor:
    """:func:`attention_heads_last_dropout` with the uint8 (B, H, S, S) keep
    mask given, so a test can hand it the mask the JAX package drew."""
    if q.shape[-1] % n_head:
        raise ValueError(f"attention_heads_last_dropout: width {q.shape[-1]} not divisible "
                         f"by {n_head}")
    _device_of(q)
    return _DropoutAttention.apply(q, k, v, key_mask, keep, n_head, rate)


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
    _device_of(q)
    return _Attention.apply(q, k, v, key_mask, n_head)


def attention_flash_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    n_head: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`attention_flash_fwd` as its own callable (the
    JAX package's ``_sdpa_flash_bwd_impl``, which its ring attention calls
    apart from the forward): q, k, v, the forward's out and lse, and dO ->
    dq, dk, dv (B, S, D). On a fully masked row it gives the gradient of the
    uniform average, as K1 and XLA do, not the JAX flash kernel's zeros."""
    if q.shape[-1] % n_head:
        raise ValueError(f"attention_flash_bwd: width {q.shape[-1]} not divisible by {n_head}")
    return _bwd_route(q, k, v, key_mask, out, lse, dout, n_head)


def attention_flash(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> torch.Tensor:
    """Long-context attention on separate heads-last q, k, v: (B, S, D) x3 ->
    (B, S, D), differentiable.

    The JAX package's ``attention_flash``, whose TPU route past the resident
    flash kernels' VMEM envelope is the streaming kernels K4
    (``_sdpa_flash_fwd_stream_impl``, ``_sdpa_flash_bwd_stream_impl``), with
    nothing of the sequence resident. Here the forward kernel streams key
    tiles and the backward key and query tiles through shared memory at any
    S, so this is :func:`attention_heads_last` (the same Function and
    kernels) behind JAX's head-dim rules. S needs no padding to a multiple of 128: the kernels mask the
    ragged last tile. A fully masked row gives the uniform average over V
    and its gradient, the port's convention (K1 and XLA); JAX's K4 gives 0
    there.

    Like JAX it refuses a head dim that is neither a multiple nor a divisor
    of 128 (its ``_hl_block_width``); on the card the kernel route refuses
    one the kernels have no instance of (Dh 32, 64, 128, 256, 384 and 768
    pass both rules). JAX's ``sharded=`` (a multi-chip mesh) is not taken."""
    d = q.shape[-1]
    dh = d // n_head if d % n_head == 0 else None
    if dh is None or not (dh % 128 == 0 or 128 % dh == 0):
        raise ValueError(
            f"attention_flash: head dim {d / n_head:g} ({d}/{n_head}) has no heads-last "
            "flash layout (needs Dh % 128 == 0 or 128 % Dh == 0)"
        )
    return attention_heads_last(q, k, v, key_mask, n_head=n_head)
