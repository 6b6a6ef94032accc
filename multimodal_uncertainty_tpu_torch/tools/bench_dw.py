"""dW microbench: the port of the repository's ``tools/bench_dw.py``.

A Linear's weight gradient dW = x^T dy contracts the K = B * S axis that
leads both operands. This tool times that product on the training shape of
the fusion MLP's largest dW (x bf16 (70144, 768), dy bf16 (70144, 3072),
fp32 sums and output) four ways:

- ``fwd_ref``: the forward-shaped product on the same bytes, x @ dy[:Din]
  (dy's first Din rows as a stand-in (Din, Dout) weight), fp32 out: the
  speed-of-light reference;
- ``plain``: ``x^T @ dy`` with fp32 output (the JAX tool's ``xla`` einsum);
- ``plain_pre_t``: the same from an x stored transposed, (Din, K) (its
  ``xla_pre_t``): what a layout change of the stored activation buys;
- ``kernel``: the hand-written dW kernel K8 (``csrc/dw.cu`` through
  ``ops/dw.py::weight_grad``), in place of the JAX tool's
  ``pallas_bk*_bn*`` sweep of its prototype kernel: K8's tiling is internal.

The three yardsticks are PyTorch calls (cuBLAS on the card, TF32 off) that
the port's training path never makes. On the card a bf16 product with fp32
output is ``torch.mm(..., out_dtype=torch.float32)`` (bf16 on the tensor
cores, fp32 sums); on the CPU, which has no such product, the operands are
widened to fp32 first.

Each row runs one warm-up call, then ``--iters`` calls whose outputs are
summed (so they run in order), timed with CUDA events on the card and the
host clock on the CPU, and prints ms a call and TFLOP/s of 2 K Din Dout.

    python -m multimodal_uncertainty_tpu_torch.tools.bench_dw [--k 70144] [--din 768]
        [--dout 3072] [--iters 30] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from multimodal_uncertainty_tpu_torch.device import resolve_device
from multimodal_uncertainty_tpu_torch.ops.dw import weight_grad
from multimodal_uncertainty_tpu_torch.tools import elapsed_ms


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--k", type=int, default=70144, help="rows: 256 x 274, batch x sequence")
    p.add_argument("--din", type=int, default=768)
    p.add_argument("--dout", type=int, default=3072, help="the MLP's c_fc, the largest dW")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p.parse_args(argv)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 output: bf16 operands on the card's tensor cores with
    fp32 sums; widened to fp32 on the CPU."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def race(fn, args, iters: int, flops: int, device: torch.device) -> dict:
    float(fn(*args).sum())

    def calls():
        acc = fn(*args)
        for _ in range(iters - 1):
            acc = acc + fn(*args)
        return acc

    ms = elapsed_ms(device, calls) / iters
    return {"ms": ms, "tf_s": flops / ms / 1e9}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(args.k, args.din)).astype(np.float32)).to(
        device=device, dtype=torch.bfloat16)
    dy = torch.from_numpy(rng.normal(size=(args.k, args.dout)).astype(np.float32)).to(
        device=device, dtype=torch.bfloat16)
    xt = x.t().contiguous()  # (Din, K): x stored d-major
    flops = 2 * args.k * args.din * args.dout
    rows = {
        "fwd_ref": race(lambda x, dy: mm_f32(x, dy[:args.din]), (x, dy), args.iters,
                        flops, device),
        "plain": race(lambda x, dy: mm_f32(x.t(), dy), (x, dy), args.iters, flops, device),
        "plain_pre_t": race(mm_f32, (xt, dy), args.iters, flops, device),
        "kernel": race(weight_grad, (x, dy), args.iters, flops, device),
    }
    print(json.dumps(rows, indent=1), flush=True)
    return rows


if __name__ == "__main__":
    main()
