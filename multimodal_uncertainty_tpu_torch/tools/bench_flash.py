"""Long-context attention bench: the port of the repository's ``tools/bench_flash.py``.

At each sequence length S, with B * S held at ``--tokens`` so that each row
does the same S-scaling work, it races forward only (serving) and forward +
backward (training):

- ``plain_fwd`` / ``plain_train``: the plain PyTorch version
  (``attention_fwd_plain``, differentiated by autograd), which puts the
  B * H * S^2 fp32 logits in device memory: the counterpart of the JAX
  tool's ``xla_*`` rows;
- ``flash_fwd`` / ``flash_train``: ``attention_flash`` on the hand-written
  forward and backward kernels, the counterpart of its ``flash_*`` rows (the
  streaming TPU kernels K4 at long S).

The JAX tool's ``whole_seq_*`` rows measured where the TPU's whole-sequence
kernels stop fitting VMEM; the port has one kernel family for every S, so
those rows have no counterpart here.

Inputs as in the JAX tool: q, k, v drawn from ``np.random.default_rng(0)``
and cast to bf16; the first half of the batch has its last fifth of keys
masked. Each row runs one warm-up call, then ``--iters`` steps chained
through a data dependency (the next step's q is ``lead * 1e-3 + q``, ``lead``
the output or dq), timed with CUDA events on the card, the host clock on the
CPU. A row prints ms a step and TFLOP/s (4 B S^2 D operations forward, 10 B
S^2 D more backward) and the kernels' launches in the row (0 on the CPU). A
plain row that fails (the training row runs out of memory at long S: 12.9 GB
of fp32 logits at S = 16384) records the error, as the JAX tool does; a
flash row's failure ends the run.

    python -m multimodal_uncertainty_tpu_torch.tools.bench_flash [--iters 10] [--dh 64]
        [--d 768] [--tokens 16384] [--seqs 512,1024,2048,4096,8192,16384] [--device cpu]
"""
from __future__ import annotations

import argparse
import gc
import json
from typing import Optional, Sequence

import numpy as np
import torch

from multimodal_uncertainty_tpu_torch.device import resolve_device
from multimodal_uncertainty_tpu_torch.ops import attention as A
from multimodal_uncertainty_tpu_torch.tools import elapsed_ms


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--dh", type=int, default=64)
    p.add_argument("--d", type=int, default=768)
    p.add_argument("--tokens", type=int, default=16384, help="B * S of every row")
    p.add_argument("--seqs", default="512,1024,2048,4096,8192,16384")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p.parse_args(argv)


def _lead(out) -> torch.Tensor:
    return out[0] if isinstance(out, tuple) else out


def _forward(attn, mask, h):
    def f(q, k, v):
        return attn(q, k, v, mask, n_head=h)

    return f


def _train(attn, mask, h):
    def f(q, k, v):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        loss = attn(q, k, v, mask, n_head=h).float().square().sum()
        return torch.autograd.grad(loss, (q, k, v))

    return f


def _plain(q, k, v, key_mask, *, n_head):
    return A.attention_fwd_plain(q, k, v, key_mask, n_head=n_head)[0]


def timed(fn, q, k, v, iters: int, device: torch.device) -> float:
    """ms a step of ``fn`` after one warm-up call, steps chained through q."""
    float(_lead(fn(q, k, v)).float().sum())

    def steps():
        x = q
        for _ in range(iters):
            x = _lead(fn(x, k, v)) * 1e-3 + q
        return x

    return elapsed_ms(device, steps) / iters


def main(argv: Optional[Sequence[str]] = None) -> list:
    args = parse_args(argv)
    device = resolve_device(args.device)
    h = args.d // args.dh
    rng = np.random.default_rng(0)
    counters = (A.attention_fwd_cuda, A.attention_bwd_cuda)
    results = []
    for s in (int(x) for x in args.seqs.split(",")):
        b = max(1, args.tokens // s)
        q, k, v = (torch.from_numpy(rng.normal(size=(b, s, args.d)).astype(np.float32))
                   .to(device=device, dtype=torch.bfloat16) for _ in range(3))
        m = np.ones((b, s), bool)
        m[: max(1, b // 2), (4 * s) // 5:] = False  # padded keys, as the JAX tool
        mask = torch.from_numpy(m).to(device)
        flops_fwd = 2 * 2 * b * s * s * args.d  # QK^T + PV
        flops_train = flops_fwd + 5 * 2 * b * s * s * args.d
        row = {"S": s, "B": b, "H": h, "Dh": args.dh}
        for label, attn, make, flops in (
            ("plain_fwd", _plain, _forward, flops_fwd),
            ("flash_fwd", A.attention_flash, _forward, flops_fwd),
            ("plain_train", _plain, _train, flops_train),
            ("flash_train", A.attention_flash, _train, flops_train),
        ):
            fn = make(attn, mask, h)
            before = [c.launches for c in counters]
            if label.startswith("plain"):
                try:
                    ms = timed(fn, q, k, v, args.iters, device)
                except RuntimeError as exc:  # out of memory: recorded, as the JAX tool does
                    row[label] = f"{type(exc).__name__}: {exc}"[:110]
                    ms = None
                gc.collect()
                if device.type == "cuda":
                    torch.cuda.empty_cache()
            else:
                ms = timed(fn, q, k, v, args.iters, device)
            if ms is not None:
                row[label] = {"ms": ms, "tf_s": flops / ms / 1e9,
                              "launches": {c.__name__: c.launches - n
                                           for c, n in zip(counters, before)}}
        results.append(row)
        print(json.dumps(row), flush=True)
    return results


if __name__ == "__main__":
    main()
