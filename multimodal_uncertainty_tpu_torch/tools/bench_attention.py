"""Kernel bench: the attention, dW and LayerNorm kernels at fixed rows,
beside one PyTorch call of the same function and the card's bound.

An attention row is ``pass:dtype:B:S:Dh:mask`` with D = 768 (H = 768 / Dh
heads): ``fwd`` times ``attention_flash_fwd`` (one forward launch), ``bwd``
times ``attention_flash_bwd`` (one backward launch) from the forward's out
and lse, ``fwd_dropout`` the forward with dropout on the probabilities at
BERT's rate 0.1 (one launch of ``attention_fwd_dropout_cuda``; the plain
version on the CPU), ``bwd_dropout`` the backward through it (one launch of
``attention_bwd_dropout_cuda``), both with a keep mask drawn from
``torch.Generator().manual_seed(S)`` on the device, ``step`` one train step
of FLAVA fusion (the MIMO model of the train
CLI's defaults, 3 layers, 101 classes, random weights from seed 0, with
activations in the row's dtype as under ``--bf16``) at batch
B, 224 image and S - 224 text tokens. ``mask`` is ``k4`` (bench_flash's:
sample 0's last fifth of keys masked), ``ragged`` (each sample keeps a
random prefix of at least half its keys, from ``np.random.default_rng(S)``)
or ``none``; a ``step`` row takes ``none`` or ``fast_dw`` (the step with
``--fast_dw``: its Linears' dW on the kernels of ``ops/dw.py``, whose device
ms in one profiled step the row reports as ``dw_device_ms``). ``dw:dtype:K:Din:Dout``
times the dW route ``ops/dw.py::weight_grad`` (``dw_cuda`` on the card) on
randn x (K, Din) and dy (K, Dout) against ``torch.matmul(x.t(), dy)`` (TF32
off); ``dw:dtype:K:Din:Dout:kernel`` forces one kernel on the card (fp32:
``tc32``, the split-fp32 one, and ``simt``, the small-K one; bf16: ``tc``,
the stream-K one, and ``mma``, the small-K one), to race a dtype's two at one
shape;
``ln:dtype:rows:D``
the LayerNorm route ``ops/norms.py::
layer_norm_kernel`` (``layer_norm_cuda`` on the card) against
``F.layer_norm``. The defaults are the rows of the kernels redesigned for
Hopper's tensor cores, register micro-tiles and clusters (the bf16 Dh=64
forward at K4's S=16384 and MMBT's B=32, S=165; the forward at Dh 256 / 384
/ 768, B=32, S=320; the backward at Dh 256 / 384 / 768, B=128, S=320, and at
Dh 256 at FLAVA's long text, S=736; the backward at Dh 24 / 48 / 96 / 192,
B=128, S=320 (FLAVA at 32 / 16 / 8 / 4 heads), at Dh=64 at MMBT's B=32,
S=165 (with dropout too) and ViLT's S=185, and K4's in fp32; fp32 and
bf16), the fp32 forward at K4's S=16384 that shares a source, FLAVA's train
step at its default 3 heads (fp32 and bf16), the bf16 backward on the tensor
cores at Dh 96 (B=32, S=320: FLAVA at 8 heads), 256 (B=128, S=736) and 64
(MMBT's B=32, S=165), the fp32 dW at every shape of the ``--fast_dw``
paths (ViLT's K = 32 x 185 rows at fc1, fc2, qkv and proj, its pooler's
K = 32 and a ragged K = 1001; FLAVA's train step's K = 32 x 320 rows and its
projections' 32 x 224 and 32 x 96; MMBT's 32 x 165 and its image
embedding's K = 96 at 2048 x 768), and K7 at the FLAVA predictor's 10240 and
training's 40960 rows of 768 in both dtypes; the fp32 forward (split fp32 on
``wgmma``) at MMBT's S=165 and 517 (with dropout too), ViLT's S=185 and
FLAVA's S=320 at Dh 24, 48, 96, 128 and 192; the fp32 dW at K = 64, 96 and
128 (768 x 768) on its route, and at K = 32-256 on both fp32 kernels; the
bf16 forward on the tensor cores at Dh 256 (B=128, S=320 and 736: FLAVA's
``--bf16`` training) and 96 (B=32 and 128, S=320), the bf16 train step at
S=736, K6's bf16 head dims 24, 48 and 192 on the tensor cores (FLAVA at 32
/ 16 / 4 heads under ``--bf16``: the forward at B=32, S=320 with the ragged
mask and at B=128, S=320, the backward and the train step at B=128,
S=320), the bf16 forward at Dh 384 and 768 on the tensor cores (FLAVA at 2
and 1 heads under ``--bf16``: at B=32, S=320 with the ragged mask as above
and at B=128, S=320) and the bf16 train step there (B=128, S=320), K5 in
bf16 (MMBT's ``--bf16 --attention_probs_dropout 0.1``): the dropout forward
and its backward, both on the tensor cores, at B=32, S=165 and 517, and the
bf16 backward at Dh 384 and 768 on the tensor-core clusters at FLAVA's long
text too (B=128, S=736; S=320 above), and the bf16 dW at the ``--bf16
--fast_dw`` paths' shapes (FLAVA's train step's K = 32 x 320 at fc1, fc2,
out_proj and in_proj, the train CLI's 128 x 320 at fc1, MMBT's 32 x 165 at
fc1 and fc2, the poolers' K = 32, MMBT's image embedding's K = 96 at 2048 x
768, K8b's 70144 at 768 x 3072) on their routes, on both bf16 kernels at
K = 32-256 (768 x 768) and K = 96 (2048 x 768), FLAVA's bf16 train step
with ``--fast_dw`` (B=128, S=320), and the bf16 attention at Dh 128 and 32
on the tensor cores (FLAVA at 6 and 24 heads under ``--bf16``: the forward
and the backward at B=128, S=320 and at B=32, S=320 with the ragged mask,
the train step at B=128, S=320; K5, the tiny BERT's Dh 32 with dropout, as
24 heads of 32 at B=32, S=165).

Each row: one warm-up call, then ``--iters`` calls (3 at S past 4096)
timed with CUDA events on the card (queued while the card spins, so that a
kernel shorter than its launch is timed on the card), the host clock on the
CPU;
``library_ms`` is ``F.scaled_dot_product_attention`` (or its backward) on
the same inputs (with ``dropout_p`` for ``bwd_dropout``: it draws its own
mask), ``torch.matmul`` or ``F.layer_norm``, a yardstick the port never
calls; ``bound_ms`` the larger of the operations (4 B S^2 D forward, 10 B
S^2 D backward, 2 K Din Dout dW, 8 rows D LayerNorm) at the card's rate for
the input type (67 TFLOP/s fp32 FMAs, 989 TFLOP/s bf16 tensor cores) and the
bytes (each input read once, each output written once) at 3.35 TB/s (a
``step`` row has neither: null). An fp32 dW row carries both of its bounds:
``fma_bound_ms`` on the FMA units and ``tc32_bound_ms``, its three TF32
products at 495 TFLOP/s, the split-fp32 kernel's own, which is its
``bound_ms``; an fp32 ``fwd`` or ``fwd_dropout`` row carries the same two, of
4 B S^2 D, and its ``bound_ms`` is the one of the kernel ``fwd_source``
routes it to (the split one on ``attention_fwd_tc32*``, else the FMA one). ``launches`` is
the kernels' counters' change over the row (``launches_tc`` /
``launches_tc32`` the bf16 / split-fp32 tensor-core routes'). One JSON line
a row.

To time another checkout's kernels with these rows (e.g. a parent commit
unpacked with ``git archive``), run this file from that checkout's root:
``PYTHONPATH=. python <this checkout>/multimodal_uncertainty_tpu_torch/tools/bench_attention.py``.

    python -m multimodal_uncertainty_tpu_torch.tools.bench_attention [--rows ROW,ROW]
        [--iters 10] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from multimodal_uncertainty_tpu_torch.device import resolve_device
from multimodal_uncertainty_tpu_torch.ops import attention as A

D = 768
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
TF32_FLOPS = 495e12  # the split-fp32 kernels' rate: three TF32 products for each fp32 one
TC32_SOURCE = "attention_fwd_tc32"  # ops/attention.py's (a parent checkout may lack the name)
QUEUE_CYCLES = 400_000  # ~0.2 ms of the card's clock a timed call: more than the host's launch
LONG_ITERS = 3  # iterations of a row past S=4096 (K4's S=16384 takes 35-130 ms a call)
DROPOUT_RATE = 0.1  # a bwd_dropout row's: BERT's attention-probs dropout
DEFAULT_ROWS = ("fwd:bfloat16:1:16384:64:k4,fwd:bfloat16:32:165:64:ragged,"
                "fwd:float32:32:320:256:ragged,fwd:bfloat16:32:320:256:ragged,"
                "fwd:float32:32:320:768:ragged,fwd:float32:32:320:384:ragged,"
                "fwd:bfloat16:32:320:768:ragged,fwd:bfloat16:32:320:384:ragged,"
                "bwd:float32:128:320:256:none,bwd:bfloat16:128:320:256:none,"
                "bwd:float32:128:736:256:none,"
                "bwd:float32:128:320:768:none,bwd:float32:128:320:384:none,"
                "bwd:bfloat16:128:320:768:none,bwd:bfloat16:128:320:384:none,"
                "bwd:float32:32:165:64:ragged,bwd:float32:32:185:64:ragged,"
                "bwd_dropout:float32:32:165:64:ragged,"
                "bwd:float32:128:320:24:none,bwd:float32:128:320:48:none,"
                "bwd:float32:128:320:96:none,bwd:float32:128:320:192:none,"
                "bwd:bfloat16:128:320:96:none,bwd:bfloat16:32:320:96:none,"
                "bwd:bfloat16:128:736:256:none,bwd:bfloat16:32:165:64:ragged,"
                "fwd:float32:1:16384:64:k4,bwd:float32:1:16384:64:k4,"
                "step:float32:128:320:256:none,step:bfloat16:128:320:256:none,"
                "step:bfloat16:128:736:256:none,"
                "fwd:bfloat16:128:320:256:none,fwd:bfloat16:128:736:256:none,"
                "fwd:bfloat16:32:320:96:ragged,fwd:bfloat16:128:320:96:none,"
                "fwd:bfloat16:32:320:24:ragged,fwd:bfloat16:32:320:48:ragged,"
                "fwd:bfloat16:32:320:192:ragged,bwd:bfloat16:128:320:24:none,"
                "bwd:bfloat16:128:320:48:none,bwd:bfloat16:128:320:192:none,"
                "fwd:bfloat16:128:320:192:none,fwd:bfloat16:128:320:48:none,"
                "fwd:bfloat16:128:320:24:none,step:bfloat16:128:320:192:none,"
                "step:bfloat16:128:320:48:none,step:bfloat16:128:320:24:none,"
                "dw:float32:5920:768:3072,dw:float32:5920:3072:768,dw:float32:5920:768:2304,"
                "dw:float32:5920:768:768,dw:float32:32:768:768,dw:float32:1001:768:768,"
                "dw:float32:10240:768:3072,dw:float32:10240:3072:768,"
                "dw:float32:10240:768:2304,dw:float32:10240:768:768,dw:float32:7168:768:768,"
                "dw:float32:3072:768:768,dw:float32:5280:768:3072,dw:float32:5280:3072:768,"
                "dw:float32:5280:768:768,dw:float32:96:2048:768,"
                "fwd:float32:32:165:64:ragged,fwd:float32:32:517:64:ragged,"
                "fwd:float32:32:185:64:ragged,fwd_dropout:float32:32:165:64:ragged,"
                "fwd_dropout:float32:32:517:64:ragged,"
                "fwd:float32:32:320:24:ragged,fwd:float32:32:320:48:ragged,"
                "fwd:float32:32:320:96:ragged,fwd:float32:32:320:128:ragged,"
                "fwd:float32:32:320:192:ragged,"
                "dw:float32:64:768:768,dw:float32:96:768:768,dw:float32:128:768:768,"
                "dw:float32:32:768:768:simt,"
                "dw:float32:32:768:768:tc32,dw:float32:64:768:768:simt,"
                "dw:float32:64:768:768:tc32,dw:float32:96:768:768:simt,"
                "dw:float32:96:768:768:tc32,dw:float32:128:768:768:simt,"
                "dw:float32:128:768:768:tc32,dw:float32:96:2048:768:simt,"
                "dw:float32:96:2048:768:tc32,dw:float32:192:768:768:simt,"
                "dw:float32:192:768:768:tc32,dw:float32:256:768:768:simt,"
                "dw:float32:256:768:768:tc32,"
                "ln:float32:10240:768,ln:bfloat16:10240:768,ln:float32:40960:768,"
                "ln:bfloat16:40960:768,"
                "fwd:bfloat16:128:320:384:none,fwd:bfloat16:128:320:768:none,"
                "step:bfloat16:128:320:384:none,step:bfloat16:128:320:768:none,"
                "fwd_dropout:bfloat16:32:165:64:ragged,bwd_dropout:bfloat16:32:165:64:ragged,"
                "bwd_dropout:bfloat16:32:517:64:ragged,"
                "bwd:bfloat16:128:736:768:none,bwd:bfloat16:128:736:384:none,"
                "fwd_dropout:bfloat16:32:517:64:ragged,"
                "dw:bfloat16:10240:768:3072,dw:bfloat16:10240:3072:768,"
                "dw:bfloat16:10240:768:768,dw:bfloat16:10240:768:2304,"
                "dw:bfloat16:40960:768:3072,dw:bfloat16:5280:768:3072,"
                "dw:bfloat16:5280:3072:768,dw:bfloat16:32:768:768,dw:bfloat16:96:2048:768,"
                "dw:bfloat16:70144:768:3072,"
                "dw:bfloat16:32:768:768:mma,dw:bfloat16:32:768:768:tc,"
                "dw:bfloat16:64:768:768:mma,dw:bfloat16:64:768:768:tc,"
                "dw:bfloat16:96:768:768:mma,dw:bfloat16:96:768:768:tc,"
                "dw:bfloat16:128:768:768:mma,dw:bfloat16:128:768:768:tc,"
                "dw:bfloat16:192:768:768:mma,dw:bfloat16:192:768:768:tc,"
                "dw:bfloat16:256:768:768:mma,dw:bfloat16:256:768:768:tc,"
                "dw:bfloat16:96:2048:768:mma,dw:bfloat16:96:2048:768:tc,"
                "step:bfloat16:128:320:256:fast_dw,"
                "fwd:bfloat16:128:320:128:none,fwd:bfloat16:32:320:128:ragged,"
                "bwd:bfloat16:128:320:128:none,bwd:bfloat16:32:320:128:ragged,"
                "step:bfloat16:128:320:128:none,"
                "fwd:bfloat16:128:320:32:none,fwd:bfloat16:32:320:32:ragged,"
                "bwd:bfloat16:128:320:32:none,bwd:bfloat16:32:320:32:ragged,"
                "step:bfloat16:128:320:32:none,"
                "fwd_dropout:bfloat16:32:165:32:ragged,bwd_dropout:bfloat16:32:165:32:ragged")
IMG_PADDED, N_CLASSES, LAYERS = 224, 101, 3  # a step row's FLAVA model and image tokens


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rows", default=DEFAULT_ROWS,
                   help="pass:dtype:B:S:Dh:mask, dw:dtype:K:Din:Dout or ln:dtype:rows:D, "
                        "comma-separated")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p.parse_args(argv)


# a dw row's forced kernel by dtype: dw_cuda's route
DW_KERNELS = {"float32": ("tc32", "simt"), "bfloat16": ("tc", "mma")}
PASSES = ("fwd", "fwd_dropout", "bwd", "bwd_dropout", "step")


def parse_row(spec: str) -> dict:
    fields = spec.split(":")
    if fields[0] in ("dw", "ln"):
        names = ("K", "Din", "Dout") if fields[0] == "dw" else ("rows", "D")
        kernel = fields.pop() if fields[0] == "dw" and len(fields) == 6 else None
        if (len(fields) != 2 + len(names) or fields[1] not in ("float32", "bfloat16")
                or fields[0] == "dw" and (int(fields[3]) % 128 or int(fields[4]) % 128)
                or kernel is not None and kernel not in DW_KERNELS.get(fields[1], ())):
            raise ValueError(f"bad row {spec!r}: want dw:dtype:K:Din:Dout (Din, Dout multiples "
                             f"of 128), dw:float32:K:Din:Dout:(tc32|simt), "
                             f"dw:bfloat16:K:Din:Dout:(tc|mma) or ln:dtype:rows:D")
        row = {"pass": fields[0], "dtype": getattr(torch, fields[1]),
               **{n: int(v) for n, v in zip(names, fields[2:])}}
        return {**row, "kernel": kernel} if kernel else row
    which, dtype, b, s, dh, mask = fields
    masks = ("none", "fast_dw") if which == "step" else ("k4", "ragged", "none")
    if (which not in PASSES or mask not in masks or D % int(dh)
            or which == "step" and int(s) <= IMG_PADDED):
        raise ValueError(f"bad row {spec!r}: want (fwd|fwd_dropout|bwd|bwd_dropout):dtype:B:S:"
                         f"Dh:(k4|ragged|none) or step:dtype:B:S:Dh:(none|fast_dw) with S > "
                         f"{IMG_PADDED}")
    return {"pass": which, "dtype": getattr(torch, dtype), "B": int(b), "S": int(s),
            "Dh": int(dh), "mask": mask}


def key_mask(kind: str, b: int, s: int, device) -> Optional[torch.Tensor]:
    if kind == "none":
        return None
    m = np.ones((b, s), bool)
    if kind == "k4":
        m[0, (4 * s) // 5:] = False
    else:
        keep = np.random.default_rng(s).integers((s + 1) // 2, s + 1, size=b)
        m = np.arange(s)[None, :] < keep[:, None]
    return torch.from_numpy(m).to(device)


def _ms(fn, iters: int, device: torch.device) -> float:
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        # the card spins while the host queues the calls: a kernel shorter than its Python
        # launch is timed on the card, not at the host's launch rate
        torch.cuda._sleep(QUEUE_CYCLES * iters)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


COUNTERS = ("launches", "launches_tc", "launches_tc32")  # (a parent checkout may lack one)


def _launches() -> dict:
    return {name: tuple(getattr(w, c, 0) for c in COUNTERS)
            for name, w in (("attention_fwd_cuda", A.attention_fwd_cuda),
                            ("attention_fwd_dropout_cuda", A.attention_fwd_dropout_cuda),
                            ("attention_bwd_cuda", A.attention_bwd_cuda),
                            ("attention_bwd_dropout_cuda", A.attention_bwd_dropout_cuda))}


def _launch_delta(before: dict, after: dict) -> dict:
    """The counters' change: ``launches``, ``launches_tc`` and ``launches_tc32`` by wrapper."""
    return {key: {name: after[name][i] - before[name][i] for name in after}
            for i, key in enumerate(COUNTERS)}


def step_row(row: dict, device: torch.device):
    """A FLAVA train step's function at ``row``'s batch, S, heads and dtype
    (the activations', as the train CLI's ``--bf16`` sets them), with
    ``--fast_dw`` where the row's mask field says so."""
    from multimodal_uncertainty_tpu_torch.models.layers import set_fast_dw
    from multimodal_uncertainty_tpu_torch.training import steps
    from multimodal_uncertainty_tpu_torch.zoo import setup_flava

    b, s, dtype = row["B"], row["S"], row["dtype"]
    setup = setup_flava(model_type="MIMO-shuffle-instance", n_classes=N_CLASSES,
                        multimodal_num_attention_heads=D // row["Dh"],
                        multimodal_num_hidden_layers=LAYERS, seed=0, dtype=dtype,
                        device=device)
    set_fast_dw(setup.model, row["mask"] == "fast_dw")
    g = torch.Generator(device=device).manual_seed(2)
    x = (torch.randn(b, IMG_PADDED, D, device=device, generator=g, dtype=dtype),
         torch.randn(b, s - IMG_PADDED, D, device=device, generator=g, dtype=dtype))
    y = torch.randint(0, N_CLASSES, (b,), device=device, generator=g)
    return lambda: steps.train_step(setup.bundle, setup.optimizer, x, y,
                                    torch.Generator().manual_seed(3))


def _dw_device_ms(step) -> float:
    """The device ms of the dW kernels (``dw_kernel*`` and ``dw_reduce``) in
    one profiled call of ``step`` (``torch.profiler``'s CUDA events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and ("dw_kernel" in e.name or "dw_reduce" in e.name)) / 1e3


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _bounds(flops: float, nbytes: float, rate: float) -> dict:
    t_ops, t_bytes = flops / rate * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes
            else "bytes"}


def dw_row(row: dict, iters: int, device: torch.device) -> dict:
    """A ``dw`` row: the dW route on randn x (K, Din), dy (K, Dout)."""
    from multimodal_uncertainty_tpu_torch.ops import dw as DW

    k, din, dout, dtype = row["K"], row["Din"], row["Dout"], row["dtype"]
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(k, din, device=device, generator=g).to(dtype)
    dy = torch.randn(k, dout, device=device, generator=g).to(dtype)
    counters = ("launches", "launches_tc32", "launches_tc", "launches_simt", "launches_mma")
    before = [getattr(DW.dw_cuda, c, 0) for c in counters]
    if row.get("kernel") and device.type == "cuda":
        ms = _ms(lambda: DW.dw_cuda(x, dy, route=row["kernel"]), iters, device)
    else:
        ms = _ms(lambda: DW.weight_grad(x, dy), iters, device)
    launches = {f"dw_cuda.{c}": getattr(DW.dw_cuda, c, 0) - n for c, n in zip(counters, before)}
    flops = 2 * k * din * dout
    nbytes = k * (din + dout) * x.element_size() + din * dout * 4
    bounds = {}
    if dtype == torch.float32:  # the FMA units' bound and the split-fp32 kernel's own
        bounds = {"fma_bound_ms": _bounds(flops, nbytes, PEAK_FLOPS[dtype])["bound_ms"],
                  "tc32_bound_ms": _bounds(3 * flops, nbytes, TF32_FLOPS)["bound_ms"]}
    rate = TF32_FLOPS / 3 if dtype == torch.float32 else PEAK_FLOPS[dtype]
    return {**row, "dtype": str(dtype)[6:], "device": _device_name(device), "ms": ms,
            "library_ms": _ms(lambda: torch.matmul(x.t(), dy), iters, device),
            **_bounds(flops, nbytes, rate), **bounds, "launches": launches}


def ln_row(row: dict, iters: int, device: torch.device) -> dict:
    """An ``ln`` row: the LayerNorm route on randn x (rows, D), weights near 1."""
    from multimodal_uncertainty_tpu_torch.ops import norms as N

    rows, d, dtype = row["rows"], row["D"], row["dtype"]
    g = torch.Generator(device=device).manual_seed(2)
    x = torch.randn(rows, d, device=device, generator=g).to(dtype)
    w = 1 + 0.1 * torch.randn(d, device=device, generator=g)
    b = 0.1 * torch.randn(d, device=device, generator=g)
    wl, bl = w.to(dtype), b.to(dtype)
    before = N.layer_norm_cuda.launches
    with torch.no_grad():
        ms = _ms(lambda: N.layer_norm_kernel(x, w, b), iters, device)
        launches = {"layer_norm_cuda": N.layer_norm_cuda.launches - before}
        library_ms = _ms(lambda: torch.nn.functional.layer_norm(x, (d,), wl, bl), iters, device)
    nbytes = 2 * rows * d * x.element_size() + 2 * d * 4
    return {**row, "dtype": str(dtype)[6:], "device": _device_name(device), "ms": ms,
            "library_ms": library_ms, **_bounds(8 * rows * d, nbytes, PEAK_FLOPS[torch.float32]),
            "launches": launches}


def _keep(b: int, h: int, s: int, device: torch.device) -> torch.Tensor:
    """A dropout row's uint8 (B, H, S, S) keep mask at ``DROPOUT_RATE``, seeded by S."""
    return A.draw_keep_mask((b, h, s, s), DROPOUT_RATE,
                            generator=torch.Generator(device).manual_seed(s), device=device)


def run_row(row: dict, iters: int, device: torch.device) -> dict:
    if row["pass"] == "dw":
        return dw_row(row, iters, device)
    if row["pass"] == "ln":
        return ln_row(row, iters, device)
    b, s, dh, dtype = row["B"], row["S"], row["Dh"], row["dtype"]
    h = D // dh
    if row["pass"] == "step":
        before = _launches()
        step = step_row(row, device)
        ms = _ms(step, iters, device)
        extra = {}
        if row["mask"] == "fast_dw":
            extra["dw_device_ms"] = _dw_device_ms(step) if device.type == "cuda" else None
        return {**row, "dtype": str(dtype)[6:], "H": h, "device": _device_name(device),
                "ms": ms, "library_ms": None, "bound_ms": None, "bound_by": None,
                **_launch_delta(before, _launches()), **extra}
    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, s, D)).astype(np.float32))
                  .to(device=device, dtype=dtype) for _ in range(4))
    mask = key_mask(row["mask"], b, s, device)
    bias = None if mask is None else torch.zeros(b, 1, 1, s, device=device, dtype=dtype) \
        .masked_fill(~mask[:, None, None, :], A.NEG_INF)

    def heads(t):
        return t.reshape(b, s, h, dh).transpose(1, 2).detach().requires_grad_()

    hq, hk, hv = heads(q), heads(k), heads(v)
    isz = q.element_size()
    if row["pass"] == "fwd":
        def kernel():
            return A.attention_flash_fwd(q, k, v, mask, n_head=h)

        def library():
            with torch.no_grad():
                return torch.nn.functional.scaled_dot_product_attention(hq, hk, hv,
                                                                        attn_mask=bias)

        flops = 4 * b * s * s * D
        nbytes = 4 * b * s * D * isz + b * h * s * 4 + (0 if mask is None else b * s)
    elif row["pass"] == "fwd_dropout":
        keep = _keep(b, h, s, device)
        if device.type == "cuda":
            def kernel():
                return A.attention_fwd_dropout_cuda(q, k, v, mask, keep, n_head=h,
                                                    rate=DROPOUT_RATE)
        else:
            def kernel():
                return A.attention_probs_dropout(q, k, v, mask, n_head=h, rate=DROPOUT_RATE,
                                                 keep=keep)

        def library():
            with torch.no_grad():
                return torch.nn.functional.scaled_dot_product_attention(
                    hq, hk, hv, attn_mask=bias, dropout_p=DROPOUT_RATE)

        flops = 4 * b * s * s * D
        nbytes = (4 * b * s * D * isz + b * h * s * 4 + (0 if mask is None else b * s)
                  + b * h * s * s)
    elif row["pass"] == "bwd_dropout":
        keep = _keep(b, h, s, device)
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            hq, hk, hv, attn_mask=bias, dropout_p=DROPOUT_RATE)
        lib_g = g.reshape(b, s, h, dh).transpose(1, 2)
        if device.type == "cuda":
            out, lse = A.attention_fwd_dropout_cuda(q, k, v, mask, keep, n_head=h,
                                                    rate=DROPOUT_RATE)

            def kernel():
                return A.attention_bwd_dropout_cuda(q, k, v, mask, keep, out, lse, g, n_head=h,
                                                    rate=DROPOUT_RATE)
        else:
            def kernel():
                return A.attention_bwd_dropout_plain(q, k, v, mask, keep, g, n_head=h,
                                                     rate=DROPOUT_RATE)

        def library():
            return torch.autograd.grad(lib_out, (hq, hk, hv), lib_g, retain_graph=True)

        flops = 10 * b * s * s * D
        nbytes = (8 * b * s * D * isz + b * h * s * 4 + (0 if mask is None else b * s)
                  + b * h * s * s)
    else:
        out, lse = A.attention_flash_fwd(q, k, v, mask, n_head=h)
        lib_out = torch.nn.functional.scaled_dot_product_attention(hq, hk, hv, attn_mask=bias)
        lib_g = g.reshape(b, s, h, dh).transpose(1, 2)

        def kernel():
            return A.attention_flash_bwd(q, k, v, mask, out, lse, g, n_head=h)

        def library():
            return torch.autograd.grad(lib_out, (hq, hk, hv), lib_g, retain_graph=True)

        flops = 10 * b * s * s * D
        nbytes = 8 * b * s * D * isz + b * h * s * 4 + (0 if mask is None else b * s)
    before = _launches()
    ms = _ms(kernel, iters, device)
    launches = _launch_delta(before, _launches())
    bound, bounds = _bounds(flops, nbytes, PEAK_FLOPS[dtype]), {}
    if dtype == torch.float32 and row["pass"] in ("fwd", "fwd_dropout"):
        # the FMA units' bound and the split-fp32 kernel's own (three TF32 products an fp32
        # one); the row's is that of the kernel its launch takes
        split = _bounds(3 * flops, nbytes, TF32_FLOPS)
        bounds = {"fma_bound_ms": bound["bound_ms"], "tc32_bound_ms": split["bound_ms"]}
        if A.fwd_source(dtype, dh, row["pass"] == "fwd_dropout").startswith(TC32_SOURCE):
            bound = split
    return {**row, "dtype": str(dtype)[6:], "H": h, "device": _device_name(device),
            "ms": ms, "library_ms": _ms(library, iters, device), **bound, **bounds, **launches}


def main(argv: Optional[Sequence[str]] = None) -> list:
    args = parse_args(argv)
    device = resolve_device(args.device)
    rows = []
    for spec in args.rows.split(","):
        row = parse_row(spec)
        iters = LONG_ITERS if row.get("S", 0) > 4096 else args.iters
        r = run_row(row, iters, device)
        print(json.dumps(r), flush=True)
        rows.append(r)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
