"""Serve a trained FLAVA-fusion, MMBT or ViLT checkpoint: batch predictions (+uncertainty).

Reads packed FLAVA embedding shards, runs the FusionPredictor on the card and
writes a CSV of ensemble-mean probabilities with modality-sensitivity
diagnostics; or, with ``--serve PORT``, serves the model over HTTP. MMBT
(``--framework mmbt``: BERT + ResNet-152 on token ids and images) and ViLT
(``--framework vilt``: ViLT-B/32 on processor dicts) serve only::

    python -m multimodal_uncertainty_tpu_torch.predict \\
        --checkpoint_path results/flava/model_best_val.pt \\
        --dataset hateful-meme-dataset --phase test \\
        --model_type MIMO-shuffle-instance --out predictions.csv
    python -m multimodal_uncertainty_tpu_torch.predict --serve 0 \\
        --checkpoint_path results/flava/model_best_val.pt --n_classes 101
    python -m multimodal_uncertainty_tpu_torch.predict --framework mmbt --serve 0 \\
        --checkpoint_path results/mmbt/model_best_val.pt --n_classes 101 --uncertainty
    python -m multimodal_uncertainty_tpu_torch.predict --framework vilt --serve 0 \\
        --checkpoint_path results/vilt/model_best_val.pt --n_classes 101 --uncertainty

The checkpoint is a torch file of this package (``training/checkpoint.py``).

``--quantize int8|int8_weight`` serves every Linear in int8 (``ops/quant.py``).
``--export DIR`` writes a model-code-free artifact of any family instead
(``export.py``: ``torch.export``, symbolic batch unless ``--export_fixed_batch``;
the temperature and the int8 mode baked in; ``--export_ablations`` for MMBT's
``--uncertainty``), and ``--artifact DIR --serve PORT`` serves one without
loading any model code::

    python -m multimodal_uncertainty_tpu_torch.predict --device cpu --export art \
        --checkpoint_path results/flava/model_best_val.pt --n_classes 101
    python -m multimodal_uncertainty_tpu_torch.predict --artifact art --serve 0 --uncertainty
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import threading
from collections import Counter
from functools import partial

import numpy as np

# flags of the JAX package's CLI that this port does not serve yet
_NOT_PORTED = {
    "data_parallel": "mesh serving (--data_parallel)",
    "model_parallel": "mesh serving (--model_parallel)",
}


def _n_classes(args) -> int:
    if args.n_classes is not None:
        return args.n_classes
    if args.dataset == "food101":
        path = os.path.join(os.environ.get("DATA_DIR", ""), args.dataset, "train.jsonl")
        with open(path) as f:
            labels = [json.loads(line)["label"] for line in f if line.strip()]
        freqs = Counter()
        for row in labels:
            freqs.update(row if isinstance(row, list) else [row])
        return len(freqs)
    return 2


def build_parser() -> argparse.ArgumentParser:
    from multimodal_uncertainty_tpu_torch.train import add_device_arg

    p = argparse.ArgumentParser(prog="python -m multimodal_uncertainty_tpu_torch.predict")
    p.add_argument("--checkpoint_path", default=None,
                   help="trained checkpoint (required unless serving an --artifact)")
    p.add_argument("--dataset", default="hateful-meme-dataset",
                   choices=["food101", "hateful-meme-dataset"])
    p.add_argument("--phase", default="test")
    p.add_argument("--model_type", default="Vanilla",
                   choices=["Vanilla", "MIMO-shuffle-instance", "MultiHead"])
    p.add_argument("--multimodal_num_attention_heads", type=int, default=3)
    p.add_argument("--multimodal_num_hidden_layers", type=int, default=3)
    p.add_argument("--clstoken", action="store_true",
                   help="checkpoint was trained with learned CLS tokens")
    p.add_argument("--avg_pool", action="store_true",
                   help="checkpoint was trained with avg-pool heads")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--out", default="predictions.csv")
    p.add_argument("--uncertainty", action="store_true")
    p.add_argument("--temperature", type=float, default=1.0,
                   help="serve-time temperature: divides each head's logits before its "
                        "softmax (fit it with tools.calibrate; baked into --export artifacts)")
    p.add_argument("--quantize", default=None, choices=["int8", "int8_weight"],
                   help="int8 serving: dynamic W8A8 or weight-only (baked into --export "
                        "artifacts)")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve over HTTP instead of batch CSV prediction "
                        "(POST /v1/predict; flava {img, txt} embedding lists, "
                        "mmbt {token_ids, segment, image}, vilt processor dicts "
                        "{input_ids, attention_mask, token_type_ids, pixel_values, "
                        "pixel_mask}; 0 = ephemeral port)")
    p.add_argument("--serve_max_batch", type=int, default=32)
    p.add_argument("--serve_max_wait_ms", type=float, default=5.0)
    p.add_argument("--serve_max_pending", type=int, default=None,
                   help="admission bound on queued requests (HTTP 503 past it)")
    p.add_argument("--n_classes", type=int, default=None,
                   help="override the dataset-derived class count")
    add_device_arg(p)
    p.add_argument("--framework", default="flava", choices=["flava", "mmbt", "vilt"],
                   help="model family (mmbt and vilt: --serve and --export only)")
    # the mmbt / vilt template (must match the checkpoint)
    p.add_argument("--bert_model", default="bert-base-uncased",
                   choices=["bert-base-uncased", "bert-large-uncased"])
    p.add_argument("--vocab_size", type=int, default=30522)
    p.add_argument("--num_image_embeds", type=int, default=3)
    p.add_argument("--tiny", action="store_true",
                   help="shrunken mmbt / vilt template (hidden 64, 2 heads, 2 layers; "
                        "mmbt's ResNet (1, 1, 1, 1)); must match a --tiny checkpoint")
    p.add_argument("--export", default=None, metavar="DIR",
                   help="write a model-code-free serving artifact (torch.export: program.pt2 "
                        "+ meta.json, the attention kernels kept, symbolic batch) instead of "
                        "predicting")
    p.add_argument("--export_img_len", type=int, default=224,
                   help="padded image-token length baked into a flava --export")
    p.add_argument("--export_txt_len", type=int, default=96,
                   help="padded text-token length baked into --export (vilt: at most its "
                        "40 text positions, and cut to them)")
    p.add_argument("--export_ablations", action="store_true",
                   help="mmbt --export: a keep-mask input, so --artifact --serve --uncertainty "
                        "works (flava and vilt artifacts take their masks as inputs anyway)")
    p.add_argument("--export_fixed_batch", type=int, default=None, metavar="B",
                   help="--export: bake batch size B (default: a symbolic batch)")
    p.add_argument("--artifact", default=None, metavar="DIR",
                   help="serve an --export artifact (needs --serve): loads no model code")
    for flag in _NOT_PORTED:
        p.add_argument(f"--{flag}", default=None, help="not ported yet: rejected")
    return p


def _mmbt_predictor(args):
    """MMBTPredictor over the checkpoint, with the template the flags name."""
    from multimodal_uncertainty_tpu_torch.models.bert import BertConfig
    from multimodal_uncertainty_tpu_torch.serving import MMBTPredictor
    from multimodal_uncertainty_tpu_torch.zoo import build_mmbt

    if args.tiny:
        cfg = dataclasses.replace(BertConfig.base(), hidden_size=64, num_hidden_layers=2,
                                  num_attention_heads=2, intermediate_size=128)
        resnet_layers = (1, 1, 1, 1)
    else:
        cfg = BertConfig.large() if args.bert_model == "bert-large-uncased" else BertConfig.base()
        resnet_layers = (3, 8, 36, 3)
    model = build_mmbt(_n_classes(args), bert_config=cfg, resnet_layers=resnet_layers,
                       num_image_embeds=args.num_image_embeds, vocab_size=args.vocab_size,
                       device="cpu")
    return MMBTPredictor(model, args.checkpoint_path, batch_buckets=(args.serve_max_batch,),
                         quantize=args.quantize, temperature=args.temperature,
                         device=args.device)


def _vilt_predictor(args):
    """ViltPredictor over the checkpoint: ViLT-B/32, or the JAX CLI's tiny
    template with ``--tiny``."""
    from multimodal_uncertainty_tpu_torch.models.vilt import ViltConfig
    from multimodal_uncertainty_tpu_torch.serving import ViltPredictor
    from multimodal_uncertainty_tpu_torch.zoo import build_vilt

    n_classes = _n_classes(args)
    cfg = None
    if args.tiny:
        cfg = dataclasses.replace(ViltConfig.b32(), hidden_size=64, num_hidden_layers=2,
                                  num_attention_heads=2, intermediate_size=128,
                                  num_labels=n_classes, image_size=384)
    model = build_vilt(n_classes, vilt_config=cfg, device="cpu")
    return ViltPredictor(model, args.checkpoint_path, batch_buckets=(args.serve_max_batch,),
                         quantize=args.quantize, temperature=args.temperature,
                         device=args.device)


def _serve(args, predictor):
    from multimodal_uncertainty_tpu_torch.server import (
        PredictionServer,
        fusion_request,
        mmbt_request,
        uncertainty_result,
        vilt_request,
    )
    from multimodal_uncertainty_tpu_torch.serving import (
        fusion_micro_batcher,
        mmbt_micro_batcher,
        vilt_micro_batcher,
    )

    if args.framework == "mmbt":
        batcher, decode = mmbt_micro_batcher, mmbt_request
    elif args.framework == "vilt":
        batcher = vilt_micro_batcher
        decode = partial(vilt_request, max_len=predictor.max_text_len)
    else:
        batcher, decode = fusion_micro_batcher, fusion_request
    mb = batcher(predictor, max_batch=args.serve_max_batch, max_wait_ms=args.serve_max_wait_ms,
                 max_pending=args.serve_max_pending, uncertainty=args.uncertainty)
    srv = PredictionServer(
        mb, decode, port=args.serve,
        encode_result=uncertainty_result if args.uncertainty else None,
    ).start()
    _serve_forever(srv, mb)


def _export(args, predictor) -> None:
    """Write ``predictor``'s artifact to ``--export`` (``export.py``)."""
    from multimodal_uncertainty_tpu_torch import export as E

    fixed = args.export_fixed_batch
    shape = {} if fixed is None else {"symbolic_batch": False, "fixed_batch": fixed}
    if args.framework == "mmbt":
        E.export_mmbt_predictor(predictor, args.export, txt_len=args.export_txt_len,
                                image_size=224, with_ablations=args.export_ablations, **shape)
        lengths = f"txt_len={args.export_txt_len}"
    elif args.framework == "vilt":
        txt_len = min(args.export_txt_len, predictor.max_text_len)
        E.export_vilt_predictor(predictor, args.export, txt_len=txt_len, **shape)
        lengths = f"txt_len={txt_len}"
    else:
        E.export_fusion_predictor(predictor, args.export, img_len=args.export_img_len,
                                  txt_len=args.export_txt_len, **shape)
        lengths = f"img_len={args.export_img_len}, txt_len={args.export_txt_len}"
    batch = "symbolic batch" if fixed is None else f"fixed batch {fixed}"
    print(f"exported {args.framework} artifact to {args.export} ({lengths}, {batch}, the "
          f"attention kernels kept; serve it with --artifact {args.export} --serve PORT)")


def _serve_artifact(args) -> None:
    """``--artifact DIR --serve PORT``: the artifact's micro-batcher behind the
    HTTP server; nothing of ``models/``, ``zoo`` or the predictors is imported."""
    from multimodal_uncertainty_tpu_torch.export import artifact_micro_batcher, load_exported
    from multimodal_uncertainty_tpu_torch.server import (
        PredictionServer,
        fusion_request,
        mmbt_request,
        uncertainty_result,
        vilt_request,
    )

    loaded = load_exported(args.artifact, device=args.device)
    family = loaded.meta.get("family", "flava_fusion")
    decode = {"flava_fusion": fusion_request, "mmbt": mmbt_request,
              "vilt": partial(vilt_request, max_len=loaded.meta.get("txt_len"))}[family]
    mb = artifact_micro_batcher(loaded, max_batch=args.serve_max_batch,
                                max_wait_ms=args.serve_max_wait_ms,
                                max_pending=args.serve_max_pending, uncertainty=args.uncertainty)
    srv = PredictionServer(
        mb, decode, port=args.serve,
        encode_result=uncertainty_result if args.uncertainty else None,
    ).start()
    _serve_forever(srv, mb)


def _serve_forever(srv, mb):
    print(f"serving on http://{srv.host}:{srv.port} "
          f"(POST /v1/predict, GET /healthz, /statz); Ctrl-C to stop", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
        mb.close()


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    for flag, what in _NOT_PORTED.items():
        if getattr(args, flag) is not None:
            parser.error(f"{what} is not ported to PyTorch yet")
    if args.export_fixed_batch is not None and args.export_fixed_batch < 1:
        parser.error(f"--export_fixed_batch must be at least 1, got {args.export_fixed_batch}")
    if args.artifact is not None:
        if args.serve is None:
            parser.error("--artifact requires --serve PORT")
        _serve_artifact(args)
        return
    if args.checkpoint_path is None:
        parser.error("--checkpoint_path is required (unless --artifact)")
    if args.framework in ("mmbt", "vilt"):
        if args.serve is None and args.export is None:
            parser.error(f"--framework {args.framework} serves only (--serve PORT or --export "
                         f"DIR); batch CSV prediction is the flava packed-shard flow")
        pred = _mmbt_predictor(args) if args.framework == "mmbt" else _vilt_predictor(args)
        if args.export is not None:
            _export(args, pred)
        else:
            _serve(args, pred)
        return

    from multimodal_uncertainty_tpu_torch.data.flava_encoded import (
        PackedFlavaDataset,
        collate_fn_flava,
    )
    from multimodal_uncertainty_tpu_torch.device import resolve_device
    from multimodal_uncertainty_tpu_torch.serving import FusionPredictor
    from multimodal_uncertainty_tpu_torch.train import reject_heads_without_kernel
    from multimodal_uncertainty_tpu_torch.zoo import build_flava

    # a head count the card has no kernel for fails here, before any loading
    reject_heads_without_kernel(parser, args.multimodal_num_attention_heads,
                                resolve_device(args.device))

    model = build_flava(
        args.model_type, _n_classes(args),
        heads=args.multimodal_num_attention_heads,
        layers=args.multimodal_num_hidden_layers,
        clstoken=args.clstoken, avg_pool=args.avg_pool, device="cpu",
    )
    predictor = FusionPredictor(
        model, args.checkpoint_path, batch_buckets=(args.batch_size,),
        quantize=args.quantize, temperature=args.temperature, device=args.device,
    )

    if args.export is not None:
        _export(args, predictor)
        return
    if args.serve is not None:
        _serve(args, predictor)
        return

    datapath = os.path.join(os.environ.get("DATA_DIR", ""), args.dataset)
    ds = PackedFlavaDataset(os.path.join(datapath, "flava_packed"), args.phase)
    rows = []
    for start in range(0, len(ds), args.batch_size):
        items = [ds[i] for i in range(start, min(start + args.batch_size, len(ds)))]
        (img, txt), y = collate_fn_flava(items)
        il = np.asarray([i.shape[0] for i, _, _ in items])
        tl = np.asarray([t.shape[0] for _, t, _ in items])
        if args.uncertainty:
            probs, diag = predictor.predict_with_uncertainty(
                img, txt, img_lengths=il, txt_lengths=tl
            )
        else:
            probs = predictor.predict(img, txt, img_lengths=il, txt_lengths=tl)
            diag = None
        for j in range(len(items)):
            row = {
                "index": start + j,
                "label": int(y[j]),
                "pred": int(probs[j].argmax()),
                **{f"p{c}": float(probs[j, c]) for c in range(probs.shape[1])},
            }
            if diag:
                row.update({k: float(v[j]) for k, v in diag.items()})
            rows.append(row)

    with open(args.out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]) if rows else ["index"])
        writer.writeheader()
        writer.writerows(rows)
    acc = float(np.mean([r["pred"] == r["label"] for r in rows])) if rows else float("nan")
    print(f"wrote {len(rows)} predictions to {args.out} (acc {acc:.4f})")


if __name__ == "__main__":
    main()
