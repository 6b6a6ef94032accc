#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: drive its serving path on one NVIDIA
GPU and hold its hand-written CUDA kernel against the plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (each raises on failure; any failure exits non-zero):

1. build: compile ``multimodal_uncertainty_tpu_torch/csrc/*.cu`` with nvcc
   (one process per source, started together); print the build seconds, the
   compiler's register/spill report, and the card's name and power limit;
2. kernel vs plain: the attention kernel at the fusion width (D=768, 3 heads,
   Dh=256, B=32) at S=320 and S=736, and at Dh=64/128, in fp32 and bf16, with
   ragged, image-ablated, text-ablated and fully masked rows, through both
   entry points (packed QKV; separate q/k/v with the LSE). Tolerance: 1e-4
   absolute in fp32, 2e-2 in bf16 (the two versions sum in other orders);
3. serving end to end at full width: the MIMO fusion model (768 wide, 3
   heads, 3 layers, 101 classes, random weights from a seed) saved and loaded
   through ``FusionPredictor(device="cuda")`` behind ``fusion_micro_batcher(
   uncertainty=True)`` and a ``PredictionServer``; 34 requests POSTed from 8
   threads. Every answer must be HTTP 200 with finite probabilities summing
   to 1, equal (1e-4) to the same batches run with the plain attention on the
   card, and the kernel's launch counter must show 3 layers x 3 forwards for
   every coalesced batch;
4. times (CUDA events after warm-up): kernel, plain version,
   ``F.scaled_dot_product_attention`` on the same inputs (a yardstick, used
   nowhere in the port), the kernel's bound; the predictor's samples/s at
   batch 32 and 128 (host clock), and under ``torch.profiler`` the device's
   busy share and its time by operation.

The last lines are the ``{"kernels": [...]}`` summary, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from multimodal_uncertainty_tpu_torch.device import resolve_device  # noqa: E402
from multimodal_uncertainty_tpu_torch.ops import _build  # noqa: E402
from multimodal_uncertainty_tpu_torch.ops import attention as A  # noqa: E402

# H100 SXM published peaks (dense): fp32 outside the tensor cores, bf16 on
# them, HBM bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
D, HEADS, LAYERS, N_CLASSES = 768, 3, 3, 101
IMG_TOKENS, IMG_PADDED = 197, 224
DEVICE = "cuda"
N_REQUESTS, LONG_TEXT = 32, 512
THROUGHPUT = ((32, 77), (128, 77), (32, 512))  # (batch, text tokens)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def serving_mask(b: int, s: int, rng: np.random.Generator) -> torch.Tensor:
    """Key masks of a serving batch (224 image slots + text): row 0 fully
    masked (a padded batch row), 1-8 image-ablated, 9-16 text-ablated, the rest
    ragged (197 image tokens, text of random length)."""
    t = s - IMG_PADDED
    m = np.zeros((b, s), bool)
    m[:, :IMG_TOKENS] = True
    for i in range(b):
        m[i, IMG_PADDED:IMG_PADDED + int(rng.integers(1, t + 1))] = True
    m[0] = False
    m[1:9, :IMG_PADDED] = False
    m[9:17, IMG_PADDED:] = False
    return torch.from_numpy(m).to(DEVICE)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def compare_kernel(b, s, n_head, dh, dtype, rng) -> float:
    """Kernel vs plain through both entry points; returns the max abs error."""
    d = n_head * dh
    qkv = torch.randn(b, s, 3 * d, device=DEVICE).to(dtype)
    if s > IMG_PADDED:
        mask = serving_mask(b, s, rng)
    else:
        mask = torch.rand(b, s, device=DEVICE) > 0.3
        mask[0] = False
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    ref, ref_lse = A.attention_fwd_plain(q, k, v, mask, n_head=n_head)
    out = A.attention_qkv_packed(qkv, mask, n_head=n_head)
    out2, lse = A.attention_flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), mask,
                                      n_head=n_head)
    torch.cuda.synchronize()
    errs = [max_err(out, ref), max_err(out2, ref), max_err(lse, ref_lse)]
    err = max(errs)
    print(f"kernel-vs-plain B={b} S={s} H={n_head} Dh={dh} {str(dtype)[6:]}: "
          f"out {errs[0]:.3g} out(separate) {errs[1]:.3g} lse {errs[2]:.3g}", flush=True)
    check(out.dtype == dtype and out.shape == (b, s, d) and lse.shape == (b, n_head, s),
          "kernel output dtype/shape")
    check(bool(torch.isfinite(out.float()).all()), "kernel output not finite")
    check(err <= TOL[dtype], f"kernel disagrees with plain: {err} > {TOL[dtype]}")
    return err


def cuda_ms(fn, iters: int = 30) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_attention(b, s, dtype, rng) -> dict:
    dh = D // HEADS
    qkv = torch.randn(b, s, 3 * D, device=DEVICE).to(dtype)
    mask = serving_mask(b, s, rng)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    bias = torch.zeros(b, 1, 1, s, device=DEVICE, dtype=dtype).masked_fill(
        ~mask[:, None, None, :], A.NEG_INF)

    def heads(t):
        return t.view(b, s, HEADS, dh).transpose(1, 2)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            heads(q), heads(k), heads(v), attn_mask=bias)

    isz = qkv.element_size()
    flops = 4 * b * s * s * D
    nbytes = b * s * 3 * D * isz + b * s + b * s * D * isz
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    row = {
        "B": b, "S": s, "dtype": str(dtype)[6:],
        "ms": cuda_ms(lambda: A.attention_qkv_packed(qkv, mask, n_head=HEADS)),
        "plain_ms": cuda_ms(lambda: A.attention_fwd_plain(q, k, v, mask, n_head=HEADS)),
        "library_ms": cuda_ms(library),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    print("time attention_fwd " + json.dumps(row), flush=True)
    return row


def post(port: int, payload: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict", data=payload,
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def serve_end_to_end(tmp: str) -> int:
    """Phase 3; returns the kernel launches of the main path's run."""
    from multimodal_uncertainty_tpu_torch.models import transformer as T
    from multimodal_uncertainty_tpu_torch.server import (
        PredictionServer,
        fusion_request,
        uncertainty_result,
    )
    from multimodal_uncertainty_tpu_torch.serving import FusionPredictor, fusion_micro_batcher
    from multimodal_uncertainty_tpu_torch.training.checkpoint import save_weights
    from multimodal_uncertainty_tpu_torch.zoo import build_flava

    kind = "MIMO-shuffle-instance"
    model = build_flava(kind, n_classes=N_CLASSES, heads=HEADS, layers=LAYERS, device=DEVICE,
                        generator=torch.Generator().manual_seed(0))
    ckpt = os.path.join(tmp, "model_best_val.pt")
    save_weights(model, None, ckpt)
    template = build_flava(kind, n_classes=N_CLASSES, heads=HEADS, layers=LAYERS, device="cpu",
                           generator=torch.Generator().manual_seed(1))
    pred = FusionPredictor(template, ckpt, device=DEVICE)
    mb = fusion_micro_batcher(pred, max_batch=32, max_wait_ms=5, uncertainty=True)
    batches = []
    run_batch = mb.predict_batch

    def recording(samples):
        batches.append(list(samples))
        return run_batch(samples)

    mb.predict_batch = recording

    rng = np.random.default_rng(0)
    text_lengths = [int(x) for x in rng.integers(5, 78, size=N_REQUESTS)] + [LONG_TEXT] * 2
    samples = []
    for i, lt in enumerate(text_lengths):
        img = rng.normal(size=(IMG_TOKENS, D)).astype(np.float32)
        img[0, 0] = i  # identifies the sample inside a coalesced batch
        samples.append((img, rng.normal(size=(lt, D)).astype(np.float32)))
    bodies = [json.dumps({"img": im.tolist(), "txt": tx.tolist()}).encode() for im, tx in samples]

    srv = PredictionServer(mb, fusion_request, port=0, encode_result=uncertainty_result).start()
    answers = {}
    try:
        def client(idx):
            for i in idx:
                answers[i] = post(srv.port, bodies[i])

        threads = [threading.Thread(target=client, args=(range(t, len(bodies), 8),))
                   for t in range(8)]
        A.attention_fwd_cuda.launches = 0
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = A.attention_fwd_cuda.launches
    finally:
        srv.close()
        mb.close()
    check(len(answers) == len(samples), f"{len(answers)} of {len(samples)} requests answered")
    sizes = [len(bt) for bt in batches]
    print(f"serving: {len(samples)} requests in {wall:.3f} s over {len(batches)} coalesced "
          f"batches {sizes}; kernel launches {launches}", flush=True)
    check(launches >= LAYERS * 3 * len(batches),
          f"kernel launches {launches} < {LAYERS} layers x 3 forwards x {len(batches)} batches")

    # the same batches with the plain attention on the card
    def plain_packed(qkv, key_mask=None, *, n_head):
        d = qkv.shape[-1] // 3
        return A.attention_fwd_plain(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
                                     key_mask, n_head=n_head)[0]

    T.attention_qkv_packed = plain_packed
    try:
        reference = {}
        for bt in batches:
            for smp, res in zip(bt, run_batch(bt)):
                reference[int(smp[0][0, 0])] = res
    finally:
        T.attention_qkv_packed = A.attention_qkv_packed
    worst = 0.0
    for i, (status, out) in answers.items():
        probs = np.asarray(out["probs"])
        check(status == 200, f"request {i}: HTTP {status}")
        check(probs.shape == (N_CLASSES,) and bool(np.isfinite(probs).all()),
              f"request {i}: probs shape {probs.shape} or not finite")
        check(abs(probs.sum() - 1.0) < 1e-4, f"request {i}: probs sum {probs.sum()}")
        ref_probs, ref_diag = reference[i]
        worst = max(worst, float(np.abs(probs - ref_probs).max()),
                    *(abs(out[k] - float(ref_diag[k])) for k in ref_diag))
    print(f"serving: answers vs plain attention on the card, max abs diff {worst:.3g}",
          flush=True)
    check(worst <= 1e-4, f"served answers differ from the plain attention by {worst}")

    for n, text in THROUGHPUT:
        predictor_throughput(pred, n, text, rng)
    return launches


def predictor_throughput(pred, n: int, text: int, rng, iters: int = 5) -> None:
    """Samples/s of ``predict`` (host clock; each call ends in a copy to the
    host), then one profiled pass: the device's busy share of the wall time
    and the device time by operation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    img = rng.normal(size=(n, IMG_TOKENS, D)).astype(np.float32)
    txt = rng.normal(size=(n, text, D)).astype(np.float32)
    s = IMG_PADDED + -(-text // 32) * 32
    pred.predict(img, txt)
    t0 = time.perf_counter()
    for _ in range(iters):
        pred.predict(img, txt)
    dt = time.perf_counter() - t0
    print(f"predictor: batch {n} (S={s}): {iters * n / dt:.1f} samples/s", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            pred.predict(img, txt)
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    device_ms: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device_ms[e.name] = device_ms.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    busy = sum(device_ms.values())
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile: batch {n} (S={s}): wall {wall_ms:.3f} ms/batch under the profiler, device "
          f"busy {busy:.3f} ms ({100 * busy / wall_ms:.1f} %); device ms by op: "
          + "; ".join(f"{ms:.3f} {name[:60]}" for name, ms in top), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    resolve_device("cuda")  # TF32 off: the plain fp32 references stay fp32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    t0 = time.perf_counter()
    secs = _build.build()
    print(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    for name in _build.SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if any(w in line for w in ("entry function", "registers", "spill")):
                    print(f"ptxas {name}: {line.strip()}")
    print(f"card: {smi}", flush=True)

    rng = np.random.default_rng(0)
    errs = {torch.float32: [], torch.bfloat16: []}
    for dtype in (torch.float32, torch.bfloat16):
        for s in (320, 736):
            errs[dtype].append(compare_kernel(32, s, HEADS, D // HEADS, dtype, rng))
        for n_head, dh in ((12, 64), (6, 128)):
            errs[dtype].append(compare_kernel(32, 320, n_head, dh, dtype, rng))
    errs[torch.float32].append(compare_kernel(4, 197, HEADS, D // HEADS, torch.float32, rng))

    with tempfile.TemporaryDirectory() as tmp:
        launches = serve_end_to_end(tmp)

    rows = [time_attention(32, s, dtype, rng)
            for dtype in (torch.float32, torch.bfloat16) for s in (320, 736)]
    main_row = rows[0]  # fp32 at B=32, S=224+96: the serving path's common shape
    kernels = [{
        "name": "attention_fwd",
        "route": "cuda",
        "source": "multimodal_uncertainty_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "multimodal_uncertainty_tpu/ops/attention.py:777 (_sdpa_packed_fwd_impl), "
                    ":1071 (_sdpa_flash_fwd_impl)",
        "launches": launches,
        "max_abs_err": max(errs[torch.float32]),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
