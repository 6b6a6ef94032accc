"""Serving microbench of the artifacts: the FLAVA fusion predictor's served
function live (``serving.FusionProbs`` on the model) against the same function
loaded from its ``torch.export`` artifact (``export.py``), with a symbolic
batch and with the batch baked in (port of the repository's
``tools/bench_export.py``, whose live rows are XLA and Pallas attention; here
every row runs the same attention kernels, through the one operator).

Each row: one warm-up call, then ``--iters`` calls chained through their
output, timed with CUDA events on the card and the host clock on the CPU; ms a
forward, samples/s, the attention launches a forward, and max |dp| against
the live forward. The card's name and power limit head the output. The
artifacts are written to a temporary directory and deleted.

    python -m multimodal_uncertainty_tpu_torch.tools.bench_export [--batch 256] [--iters 20]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from multimodal_uncertainty_tpu_torch import export as E
from multimodal_uncertainty_tpu_torch.device import resolve_device
from multimodal_uncertainty_tpu_torch.ops import attention as A
from multimodal_uncertainty_tpu_torch.tools import card_name, elapsed_ms


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--img_len", type=int, default=224, help="padded, as the predictor pads")
    p.add_argument("--txt_len", type=int, default=96)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--heads", type=int, default=3)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p.parse_args(argv)


class _Predictor:
    """What the exporters read of a FusionPredictor."""

    def __init__(self, model, device):
        self.model, self.device = model, device
        self.temperature, self.quantize, self.pad_multiple = 1.0, None, 32


@torch.inference_mode()
def _timed(fn, inputs, iters, device):
    img, txt, im, tm = inputs
    probs = fn(img, txt, im, tm)

    def steps():
        p = probs
        for _ in range(iters):
            p = fn(img + p.mean() * 1e-9, txt, im, tm)
        return p

    before = A.attention_fwd_cuda.launches
    ms = elapsed_ms(device, steps) / iters
    return ms, probs, (A.attention_fwd_cuda.launches - before) / iters


def main(argv: Optional[Sequence[str]] = None) -> list:
    from multimodal_uncertainty_tpu_torch.models.fusion import FlavaFusionTransformer
    from multimodal_uncertainty_tpu_torch.serving import FusionProbs

    args = parse_args(argv)
    device = resolve_device(args.device)
    print(f"card: {card_name(device)}; batch {args.batch}, (LI, LT, D) = ({args.img_len}, "
          f"{args.txt_len}, 768)", flush=True)
    model = FlavaFusionTransformer(out_dim=2, num_classes=2,
                                   multimodal_num_attention_heads=args.heads,
                                   multimodal_num_hidden_layers=args.layers,
                                   generator=torch.Generator().manual_seed(0)).to(device).eval()
    rng = np.random.default_rng(0)
    inputs = [torch.from_numpy(rng.normal(size=(args.batch, n, 768)).astype(np.float32)).to(device)
              for n in (args.img_len, args.txt_len)]
    inputs += [torch.ones((args.batch, n), dtype=torch.bool, device=device)
               for n in (args.img_len, args.txt_len)]
    pred = _Predictor(model, device)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        E.export_fusion_predictor(pred, f"{tmp}/sym", img_len=args.img_len, txt_len=args.txt_len)
        E.export_fusion_predictor(pred, f"{tmp}/fixed", img_len=args.img_len,
                                  txt_len=args.txt_len, symbolic_batch=False,
                                  fixed_batch=args.batch)
        forms = (("live", FusionProbs(model)),
                 ("artifact (symbolic batch)", E.load_exported(f"{tmp}/sym", device=device).module),
                 (f"artifact (fixed batch {args.batch})",
                  E.load_exported(f"{tmp}/fixed", device=device).module))
        ref = None
        for name, fn in forms:
            ms, probs, launches = _timed(fn, inputs, args.iters, device)
            ref = probs if ref is None else ref
            row = {"row": name, "ms": ms, "samples_per_s": args.batch * 1e3 / ms,
                   "attention_launches_per_forward": launches,
                   "max_abs_dp_vs_live": float((probs - ref).abs().max())}
            rows.append(row)
            print(json.dumps(row), flush=True)
    print("vs live: " + ", ".join(f"{r['row']} {r['samples_per_s'] / rows[0]['samples_per_s']:.3f}x"
                                  for r in rows[1:]), flush=True)
    return rows


if __name__ == "__main__":
    main()
