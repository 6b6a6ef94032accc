"""FLAVA-fusion robustness sweep over a trained checkpoint of this package.

The port of the repo-root ``eval_transformer_robustness.py``: the same flags,
the same ``robustness_{ckpt}_predictions_{phase}.npy`` (S, 3 + 2R, E, C)
float32 and ``robustness_{ckpt}_labels_{phase}.npy`` files, and the same two
summary lines. It runs on the card; pass ``--device cpu`` to run on the CPU::

    python -m multimodal_uncertainty_tpu_torch.eval_transformer_robustness \\
        --save_path results/flava --phase dev --batch_size 32 \\
        --checkpoint_path results/flava/model_best_val.pt \\
        --model_type MIMO-shuffle-instance --dataset hateful-meme-dataset

Data: packed shards under ``$DATA_DIR/<dataset>/flava_packed``; ``--phase``
is train, dev or test, and ``val`` is an alias of ``dev``. The checkpoint is
a torch file of this package (``training/checkpoint.py``), written by its
train CLI with the same ``--model_type``, head and layer counts.
"""
from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    from multimodal_uncertainty_tpu_torch.train import add_device_arg, add_vestigial_args

    p = argparse.ArgumentParser(
        prog="python -m multimodal_uncertainty_tpu_torch.eval_transformer_robustness",
        description="Eval Models")
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--phase", type=str, required=True, choices=["train", "val", "dev", "test"])
    p.add_argument("--batch_size", type=int, required=True)
    p.add_argument("--checkpoint_path", type=str, required=True)
    p.add_argument("--model_type", type=str, default="Vanilla",
                   choices=["Vanilla", "MIMO-shuffle-instance", "MultiHead"])
    add_device_arg(p)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--n_repeats", type=int, default=20)
    p.add_argument("--multimodal_num_attention_heads", type=int, default=3)
    p.add_argument("--multimodal_num_hidden_layers", type=int, default=3)
    p.add_argument("--dataset", type=str, choices=["food101", "hateful-meme-dataset"],
                   default="hateful-meme-dataset")
    p.add_argument("--sample_size", type=int, default=None)
    p.add_argument("--data_parallel", type=int, default=1,
                   help="not ported yet: rejected unless 1")
    add_vestigial_args(p)
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.data_parallel != 1:
        parser.error("mesh sweeps (--data_parallel) are not ported to PyTorch yet")

    from multimodal_uncertainty_tpu_torch.device import resolve_device
    from multimodal_uncertainty_tpu_torch.train import reject_heads_without_kernel, warn_ignored

    warn_ignored(args)
    device = resolve_device(args.device)  # raises without a card unless --device cpu
    reject_heads_without_kernel(parser, args.multimodal_num_attention_heads, device)

    from multimodal_uncertainty_tpu_torch.data.flava_encoded import get_dataset_flava
    from multimodal_uncertainty_tpu_torch.data.food101 import get_labels_and_frequencies
    from multimodal_uncertainty_tpu_torch.evals.robustness_transformer import (
        transformer_robustness_sweep,
    )
    from multimodal_uncertainty_tpu_torch.training.checkpoint import load_weights, restore_into
    from multimodal_uncertainty_tpu_torch.zoo import setup_flava

    datapath = os.path.join(os.environ["DATA_DIR"], args.dataset)
    if args.dataset == "food101":
        labels, _ = get_labels_and_frequencies(os.path.join(datapath, "train.jsonl"))
        n_classes = len(labels)
    else:
        n_classes = 2
    train, val, test = get_dataset_flava(args, datapath)
    # the reference names the splits train/dev/test; 'val' is the same split as 'dev'
    data = {"train": train, "val": val, "dev": val, "test": test}

    setup = setup_flava(
        model_type=args.model_type,
        n_classes=n_classes,
        multimodal_num_attention_heads=args.multimodal_num_attention_heads,
        multimodal_num_hidden_layers=args.multimodal_num_hidden_layers,
        seed=args.seed,
        device=device,
    )
    restore_into(setup.model, load_weights(args.checkpoint_path)[0])

    ckpt_name = args.checkpoint_path.split("/")[-1].split(".")[0]
    preds, labels = transformer_robustness_sweep(
        setup.model,
        data[args.phase],
        n_repeats=args.n_repeats,
        seed=args.seed,
        save_path=args.save_path,
        checkpoint_name=ckpt_name,
        phase=args.phase,
    )
    s, m, k, c = preds.shape
    print(
        "Gathered predictions of {} samples, {} variants, {} heads, {} classes".format(
            s, m, k, c
        )
    )
    print("Gathered labels of {} samples".format(len(labels)))
    return preds, labels


if __name__ == "__main__":
    main()
