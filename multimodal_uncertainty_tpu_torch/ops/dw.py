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
from typing import NamedTuple, Optional, Tuple

import torch

TILE = 128  # Din and Dout must be multiples of it (the output tile is 128 x 256, ragged in Din)
# the split-fp32 kernel's (Dout, Din) output tile, its K rows a stage (a split's K range is a
# multiple of it) and the rate of its products on one SM: three TF32 products a step (split fp32)
# at the 495 TFLOP/s TF32 rate (H100 SXM, 132 SMs), one block an SM. k_splits weighs a split's
# work against its slab traffic at the memory rate.
KERNELS = {torch.float32: ((128, 256), 32, 495e12 / 3 / 132)}
_MAX_SPLITS = 32
_BYTES = 3.35e12
# the bf16 tensor-core kernel's (Dout, Din) output tile and K rows a stage: the units of its
# stream-K plan
STREAM_TILE, STREAM_STAGE = (128, 256), 64
# At K <= SIMT_MAX_K (fp32) or MMA_MAX_K (bf16; the pooler's and cls_fc's K = batch 32, MMBT's
# image embedding's 96) a tensor-core kernel runs a few stages on 18 tiles of 768 x 768, most SMs
# idle; the small-K kernels' 64 x 64 tiles fill the card instead. fp32 (SIMT FMAs), in one call
# on an H100: ahead at K = 32-128 (768 x 768: 0.0049 against 0.0088 ms at K = 32, 0.0110 against
# 0.0169 at 128; 2048 x 768 at K = 96: 0.0120 against 0.0136), level at 192, behind at 256.
# bf16 (mma.sync), raced against the stream-K kernel in one call on an H100 (tools/
# bench_attention.py): ahead at every K raced, 32-256 (768 x 768: 0.0038 against 0.0082 ms at
# K = 32, 0.0077 against 0.0155 at 256; 2048 x 768: 0.0062 against 0.0159 at K = 96, 0.0104
# against 0.0260 at 256).
SIMT_MAX_K = 128
MMA_MAX_K = 256
_ROUTES = {"tc32": 0, "tc": 1, "simt": 2, "mma": 3}  # mmu_dw's route codes
_ROUTES_OF = {torch.float32: ("tc32", "simt"), torch.bfloat16: ("tc", "mma")}
_count_lock = threading.Lock()
# per (device, stream): the bf16 kernel's flags (one an SM, zeroed once) and the last epoch
_flags: dict = {}


def dw_plain(x2d: torch.Tensor, dy2d: torch.Tensor) -> torch.Tensor:
    """(K, Din) x (K, Dout) -> (Dout, Din) fp32: ``dy2d.T @ x2d`` in fp32,
    torch's weight layout (the transpose of what ``_dw_pallas_2d`` returns).
    The CPU route and the reference the kernel is held to on the card."""
    return dy2d.float().t() @ x2d.float()


def k_splits(k: int, din: int, dout: int, sms: int) -> Tuple[int, int]:
    """(splits, k_chunk): K is cut into ``splits`` chunks of ``k_chunk`` rows
    for the split-fp32 kernel (one block an SM of a card with ``sms`` SMs).
    Chunks are multiples of the kernel's stage, and the count is the one that
    minimises the modelled time: waves of (tile, chunk) work units over the
    SMs at the kernel's rate, plus the slabs written and summed back at the
    memory rate, so the units come close to whole waves; ties go to fewer
    splits. The small-K kernel (route ``simt``) takes no split."""
    tile, stage, sm_flops = KERNELS[torch.float32]
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


# a tile-aligned grid (every block inside one tile) is taken while its longest share is at most
# this many times stream-K's: stream-K's finishing blocks add a partial's read and a tile's
# store at the end of the run, where a tile-aligned grid sums slices on every block at once
ALIGNED_SLACK = 1.25


class StreamKPlan(NamedTuple):
    """The bf16 kernel's schedule; ``csrc/dw.cu::tc`` computes the same
    integers. ``tiles`` output tiles of 128 x 256 (tile t at rows 128 (t //
    ceil(Din / 256)), columns 256 (t % ceil(Din / 256))), each of ``stages``
    K stages of 64 rows, make ``iters`` (tile, stage) iterations, numbered
    tile by tile; block b of ``grid`` (one an SM) runs ``block_range(b)``."""
    tiles: int
    stages: int
    grid: int

    @property
    def iters(self) -> int:
        return self.tiles * self.stages

    @property
    def aligned(self) -> bool:
        """The grid is a multiple of the tiles, so every block's range lies
        in one tile, and a tile's blocks sum it by slices."""
        return self.grid % self.tiles == 0

    @property
    def workspace(self) -> int:
        """fp32 elements of the partials' workspace: one tile a block."""
        return self.grid * STREAM_TILE[0] * STREAM_TILE[1]

    def block_range(self, b: int) -> Tuple[int, int]:
        """Iterations [lo, hi) of block b: shares differ by at most one."""
        return self.iters * b // self.grid, self.iters * (b + 1) // self.grid

    def segments(self, b: int) -> list:
        """Block b's work as (tile, first stage, end stage, kind), in the
        order it runs them: its tiles from the top of its range down. kind
        ``whole``: the whole tile, stored as it is; ``partial``: written to
        the block's workspace slot and flagged (in a stream-K grid only a
        top segment that stops inside its tile, the block's first work; in
        an aligned grid the block's one segment, then summed by ``slice``);
        ``finish`` (stream-K only): the bottom segment that holds the tile's
        end but not its start, the block's last work, which adds the
        partials of ``waits`` and stores the tile."""
        lo, hi = self.block_range(b)
        out = []
        for tile in range((hi - 1) // self.stages, lo // self.stages - 1, -1) if hi > lo else ():
            t0 = tile * self.stages
            s0, s1 = max(lo, t0) - t0, min(hi, t0 + self.stages) - t0
            if s0 == 0 and s1 == self.stages:
                kind = "whole"
            elif s1 < self.stages or self.aligned:
                kind = "partial"
            else:
                kind = "finish"
            out.append((tile, s0, s1, kind))
        return out

    def waits(self, b: int, tile: int) -> list:
        """The blocks whose partials block b adds to finish ``tile``
        (stream-K), in the order it adds them: b - 1 down, while a block
        holds an earlier stage of the tile."""
        out, p = [], b - 1
        while p >= 0 and self.block_range(p)[1] > tile * self.stages:
            out.append(p)
            p -= 1
        return out

    def contributors(self, tile: int) -> list:
        """The blocks that hold a stage of ``tile``: a run of block indices."""
        t0, t1 = tile * self.stages, (tile + 1) * self.stages
        return [b for b in range(self.grid)
                if self.block_range(b)[0] < t1 and self.block_range(b)[1] > t0]

    def slice(self, b: int, tile: int) -> Tuple[int, int]:
        """(Aligned grid.) The float4s [f0, f1) of the tile, in the
        accumulators' order (float4 j of consumer thread t is j * 256 + t),
        that block b sums over the partials of ``contributors(tile)``, in
        block order."""
        who = self.contributors(tile)
        n, j, f4 = len(who), who.index(b), STREAM_TILE[0] * STREAM_TILE[1] // 4
        return f4 * j // n, f4 * (j + 1) // n


def stream_k_plan(k: int, din: int, dout: int, sms: int) -> StreamKPlan:
    """The bf16 kernel's plan on a card with ``sms`` SMs, one block an SM,
    each running to the end: stream-K, ``grid`` = min(SMs, iterations), or,
    where its longest share is within ``ALIGNED_SLACK`` of stream-K's, the
    tile-aligned grid tiles x s (s = min(SMs // tiles, stages) blocks a
    tile)."""
    tiles = (dout // STREAM_TILE[0]) * -(-din // STREAM_TILE[1])
    stages = -(-max(k, 1) // STREAM_STAGE)
    grid = min(sms, tiles * stages)
    if tiles <= sms:
        split = min(sms // tiles, stages)
        if -(-stages // split) <= ALIGNED_SLACK * -(-tiles * stages // grid):
            grid = tiles * split
    return StreamKPlan(tiles, stages, grid)


def dw_route(k: int, dtype: torch.dtype) -> str:
    """The kernel of ``csrc/dw.cu`` that takes K rows of ``dtype``: fp32 at
    K <= ``SIMT_MAX_K`` ``simt`` (the small-K kernel on fp32 FMAs), above it
    ``tc32`` (split fp32 on the tensor cores); bf16 at K <= ``MMA_MAX_K``
    ``mma`` (the small-K tiles on ``mma.sync``), above it ``tc`` (stream-K
    on ``wgmma``)."""
    if dtype == torch.bfloat16:
        return "mma" if k <= MMA_MAX_K else "tc"
    return "simt" if k <= SIMT_MAX_K else "tc32"


def _check(t: torch.Tensor, name: str, k: int) -> int:
    """Device, dtype, shape and alignment of an operand; returns its row stride."""
    if t.device.type != "cuda":
        raise ValueError(f"dw_cuda: {name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in _ROUTES_OF:
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
    :func:`dw_plain`). :func:`dw_route` picks the kernel: the small-K one at
    K <= ``SIMT_MAX_K`` (``MMA_MAX_K``), else fp32 the split-fp32
    tensor-core kernel and bf16 the stream-K one; their loads need row strides of 16-byte
    multiples (4 fp32 or 8 bf16 elements) and a 16-byte aligned base.
    ``route`` overrides that choice, for a benchmark to race a dtype's two
    kernels at one shape. Raises on anything the kernel does not take (no
    copy is made). Each call adds one to ``dw_cuda.launches`` and one to its
    route's count: ``launches_tc32``, ``launches_simt``, ``launches_tc`` or
    ``launches_mma``."""
    from multimodal_uncertainty_tpu_torch.ops import _build

    k = x2d.shape[0]
    ldx = _check(x2d, "x", k)
    ldy = _check(dy2d, "dy", k)
    if dy2d.device != x2d.device or dy2d.dtype != x2d.dtype:
        raise ValueError(f"dw_cuda: dy ({dy2d.dtype} on {dy2d.device}) must match x "
                         f"({x2d.dtype} on {x2d.device})")
    din, dout = x2d.shape[1], dy2d.shape[1]
    device = x2d.device
    out = torch.empty((dout, din), dtype=torch.float32, device=device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    route = route or dw_route(k, x2d.dtype)
    if route not in _ROUTES_OF[x2d.dtype]:
        raise ValueError(f"dw_cuda: no {route} kernel for {x2d.dtype}")
    stream = torch.cuda.current_stream(device)
    ws = flags = None
    epoch = 0
    if route == "tc":  # parts: the stream-K grid
        plan = stream_k_plan(k, din, dout, sms)
        parts, chunk = plan.grid, 0
        ws = torch.empty(plan.workspace, dtype=torch.float32, device=device)
        with _count_lock:
            key = (device.index or 0, stream.cuda_stream)
            if key not in _flags:
                _flags[key] = [torch.zeros(sms, dtype=torch.int32, device=device), 0]
            entry = _flags[key]
            entry[1] = entry[1] % 0xFFFFFFFF + 1  # a new epoch a launch: no reset of the flags
            flags, epoch = entry
    else:  # parts: the K splits
        parts, chunk = (1, max(k, 1)) if route in ("simt", "mma") else k_splits(k, din, dout, sms)
        if parts > 1:
            ws = torch.empty((parts, dout, din), dtype=torch.float32, device=device)
    fn = _build.load("dw").mmu_dw
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 5 + [ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(x2d.data_ptr(), ldx, dy2d.data_ptr(), ldy, out.data_ptr(),
             None if ws is None else ws.data_ptr(), None if flags is None else flags.data_ptr(),
             k, din, dout, parts, chunk, epoch, _ROUTES[route], device.index or 0,
             stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"dw kernel launch failed: CUDA error {err}")
    with _count_lock:
        dw_cuda.launches += 1
        setattr(dw_cuda, f"launches_{route}", getattr(dw_cuda, f"launches_{route}") + 1)
    return out


dw_cuda.launches = 0
dw_cuda.launches_tc = 0  # bf16 launches on the stream-K tensor-core kernel
dw_cuda.launches_tc32 = 0  # fp32 launches on the split-fp32 kernel
dw_cuda.launches_simt = 0  # fp32 launches on the small-K kernel (K <= SIMT_MAX_K)
dw_cuda.launches_mma = 0  # bf16 launches on the small-K kernel (K <= MMA_MAX_K)


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
