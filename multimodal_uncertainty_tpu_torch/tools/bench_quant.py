"""Serving microbench of the int8 modes: the FLAVA fusion forward (the
FusionPredictor's served function, ensemble-mean probabilities) at a serving
batch, four ways (port of the repository's ``tools/bench_quant.py``):

- ``fp32``: fp32 weights and activations (the predictor's default);
- ``bf16``: bf16 activations (the model's ``dtype``);
- ``int8 W8A8 (bf16 acts)``: ``--quantize int8`` over bf16 activations;
- ``int8 weight-only (bf16 acts)``: ``--quantize int8_weight`` over them.

Each row: one warm-up call, then ``--iters`` calls chained through their
output (each adds 1e-9 x the previous mean to the image features), timed with
CUDA events on the card and the host clock on the CPU; ms a forward,
samples/s, the int8 products a forward, and max |dp| against fp32. The card's
name and power limit head the output. Shapes are the JAX tool's: 197 image +
77 text tokens of 768, 3 heads, 3 layers, 2 heads of 2 classes.

    python -m multimodal_uncertainty_tpu_torch.tools.bench_quant [--batch 256] [--iters 20]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from multimodal_uncertainty_tpu_torch.device import resolve_device
from multimodal_uncertainty_tpu_torch.models.layers import set_quantize
from multimodal_uncertainty_tpu_torch.ops import quant as Q
from multimodal_uncertainty_tpu_torch.tools import card_name, elapsed_ms

ROWS = (("fp32", torch.float32, None), ("bf16", torch.bfloat16, None),
        ("int8 W8A8 (bf16 acts)", torch.bfloat16, "int8"),
        ("int8 weight-only (bf16 acts)", torch.bfloat16, "int8_weight"))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--img_len", type=int, default=197)
    p.add_argument("--txt_len", type=int, default=77)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--heads", type=int, default=3)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p.parse_args(argv)


def served(args, dtype, mode, device):
    """The fusion forward (``serving.FusionProbs``) of a seeded FLAVA model in
    ``dtype`` under ``mode``."""
    from multimodal_uncertainty_tpu_torch.models.fusion import FlavaFusionTransformer
    from multimodal_uncertainty_tpu_torch.serving import FusionProbs

    model = FlavaFusionTransformer(out_dim=2, num_classes=2, multimodal_num_attention_heads=args.heads,
                                   multimodal_num_hidden_layers=args.layers, dtype=dtype,
                                   generator=torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    set_quantize(model, mode)
    return FusionProbs(model)


@torch.inference_mode()
def main(argv: Optional[Sequence[str]] = None) -> list:
    args = parse_args(argv)
    device = resolve_device(args.device)
    print(f"card: {card_name(device)}; batch {args.batch}, (LI, LT, D) = ({args.img_len}, "
          f"{args.txt_len}, 768)", flush=True)
    rng = np.random.default_rng(0)
    img, txt = (torch.from_numpy(rng.normal(size=(args.batch, n, 768)).astype(np.float32))
                .to(device) for n in (args.img_len, args.txt_len))
    im = torch.ones((args.batch, args.img_len), dtype=torch.bool, device=device)
    tm = torch.ones((args.batch, args.txt_len), dtype=torch.bool, device=device)
    rows, ref = [], None
    for name, dtype, mode in ROWS:
        fwd = served(args, dtype, mode, device)
        probs = fwd(img, txt, im, tm)

        def steps():
            p = probs
            for _ in range(args.iters):
                p = fwd(img + p.mean() * 1e-9, txt, im, tm)
            return p

        before = Q.int8_mm_cuda.launches
        ms = elapsed_ms(device, steps) / args.iters
        ref = probs if ref is None else ref
        row = {"row": name, "ms": ms, "samples_per_s": args.batch * 1e3 / ms,
               "int8_products_per_forward": (Q.int8_mm_cuda.launches - before) / args.iters,
               "max_abs_dp_vs_fp32": float((probs - ref).abs().max())}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del fwd
    base = rows[0]["samples_per_s"]
    print("speedups vs fp32: " + ", ".join(f"{r['row']} {r['samples_per_s'] / base:.3f}x"
                                          for r in rows[1:]), flush=True)
    return rows


if __name__ == "__main__":
    main()
