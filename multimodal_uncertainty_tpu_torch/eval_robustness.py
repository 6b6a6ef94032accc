"""FashionMNIST missing-view robustness sweep over a trained checkpoint of
this package.

The port of the repo-root ``eval_robustness.py``: the same flags, the same
``{ckpt}_predictions_robustness.npy`` (M_, S, M, C) float32 and
``{ckpt}_labels.npy`` files (``evals/robustness_fmnist.py``: the four
leave-one-out variants of a batch in one forward), and the same summary lines.
It runs on the card; pass ``--device cpu`` to run on the CPU::

    python -m multimodal_uncertainty_tpu_torch.eval_robustness \\
        --checkpoint_path results/fmnist/model_best_val.pt \\
        --model_type MIMO-shuffle-instance --save_path results/fmnist

The eval split is FashionMNIST's t10k (``$DATA_DIR/FashionMNIST/raw``, or
the seeded stand-in under ``--synthetic``); the checkpoint is a torch file of
this package (``train_fashionmnist``) with the same ``--model_type``,
``--transformer`` and head and layer counts. ``--use_gpu`` and ``--verbose``
are taken and ignored; ``--data_parallel`` above 1 (mesh sweeps) is not
ported yet.
"""
from __future__ import annotations

import argparse
import os


def build_parser(prog: str) -> argparse.ArgumentParser:
    """The flags of the root ``eval_robustness.py`` and
    ``eval_prediction_saving.py`` (they take the same)."""
    from multimodal_uncertainty_tpu_torch.ops.data_forming import MULTIVIEW_MODEL_TYPES
    from multimodal_uncertainty_tpu_torch.train import add_device_arg

    ignored = "accepted for the reference CLI's sake and ignored"
    p = argparse.ArgumentParser(prog=prog, description="Eval Models")
    p.add_argument("--checkpoint_path", type=str, required=True)
    p.add_argument("--model_type", type=str, default="Vanilla", choices=MULTIVIEW_MODEL_TYPES)
    p.add_argument("--use_gpu", action="store_true", help=ignored)
    add_device_arg(p)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--data_parallel", type=int, default=1,
                   help="not ported yet: rejected unless 1")
    p.add_argument("--verbose", action="store_true", help=ignored)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--transformer", action="store_true")
    p.add_argument("--multimodal_num_attention_heads", type=int, default=3)
    p.add_argument("--multimodal_num_hidden_layers", type=int, default=3)
    p.add_argument("--dropout", type=float, default=0)
    p.add_argument("--synthetic", action="store_true")
    return p


def load_eval(parser: argparse.ArgumentParser, argv):
    """Parse ``argv``, check it, and return (args, model restored from
    ``--checkpoint_path`` on the device, the eval split's loader, checkpoint
    name)."""
    args = parser.parse_args(argv)
    if args.data_parallel != 1:
        parser.error("mesh sweeps (--data_parallel) are not ported to PyTorch yet")

    from multimodal_uncertainty_tpu_torch.data.fmnist import get_fmnist
    from multimodal_uncertainty_tpu_torch.device import resolve_device
    from multimodal_uncertainty_tpu_torch.train import reject_heads_without_kernel
    from multimodal_uncertainty_tpu_torch.training.checkpoint import load_weights, restore_into
    from multimodal_uncertainty_tpu_torch.zoo import setup_fashionmnist

    device = resolve_device(args.device)  # raises without a card unless --device cpu
    if args.transformer:
        reject_heads_without_kernel(parser, args.multimodal_num_attention_heads, device)
    setup = setup_fashionmnist(
        model_type=args.model_type,
        transformer=args.transformer,
        multimodal_num_attention_heads=args.multimodal_num_attention_heads,
        multimodal_num_hidden_layers=args.multimodal_num_hidden_layers,
        dropout=args.dropout,
        seed=args.seed,
        device=device,
    )
    _, valid, _ = get_fmnist(datapath=os.environ.get("DATA_DIR"), batch_size=args.batch_size,
                             shuffle=True, seed=args.seed, synthetic=args.synthetic)
    print("Loading Checkpoint from {}".format(args.checkpoint_path))
    restore_into(setup.model, load_weights(args.checkpoint_path)[0])
    ckpt_name = args.checkpoint_path.split("/")[-1].split(".")[0]
    return args, setup.model, valid, ckpt_name


def main(argv=None):
    from multimodal_uncertainty_tpu_torch.evals.robustness_fmnist import missing_view_sweep

    args, model, valid, ckpt_name = load_eval(
        build_parser("python -m multimodal_uncertainty_tpu_torch.eval_robustness"), argv)
    outputs, labels = missing_view_sweep(model, valid, model_type=args.model_type,
                                         save_path=args.save_path, checkpoint_name=ckpt_name)
    m_, s, m, c = outputs.shape
    print("Gathered predictions of {} samples, {} views, {} dups, {} classes".format(
        s, m_, m, c))
    print("Gathered labels of {} samples".format(len(labels)))
    print("Saving predictions and labels to {}".format(args.save_path))
    return outputs, labels


if __name__ == "__main__":
    main()
