"""Train the FLAVA-fusion classifier on precomputed FLAVA embeddings.

The port of the repo-root ``train.py --framework flava``: the same flags
(those its flava branch reads), the same ``history.csv`` and checkpoint files
(as torch files of this package), and ``--resume`` from
``model_last_epoch.pt`` with the optimizer state. It runs on the card; pass
``--device cpu`` to run on the CPU::

    python -m multimodal_uncertainty_tpu_torch.train --framework flava \\
        --save_path results/flava --dataset hateful-meme-dataset \\
        --model_type MIMO-shuffle-instance --lr 1e-4 --n_epochs 20

Data: packed shards under ``$DATA_DIR/<dataset>/flava_packed``.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from collections import Counter

logger = logging.getLogger(__name__)

# flags of the JAX package's CLI that this port does not take yet, with the
# value that means "off"
_NOT_PORTED = {
    "bf16": (False, "bf16 training (--bf16)"),
    "remat": (False, "rematerialised blocks (--remat)"),
    "fast_dw": (False, "the Pallas dW kernel (--fast_dw)"),
    "diversity": ("none", "diversity training (--diversity)"),
    "ckpt_backend": ("msgpack", "the orbax checkpoint backend (--ckpt_backend orbax)"),
    "data_parallel": (1, "mesh training (--data_parallel)"),
    "model_parallel": (1, "mesh training (--model_parallel)"),
    "sequence_parallel": (1, "ring attention (--sequence_parallel)"),
    "pipeline_parallel": (1, "pipeline training (--pipeline_parallel)"),
    "pipeline_microbatches": (None, "pipeline training (--pipeline_microbatches)"),
    "fsdp": (False, "FSDP (--fsdp)"),
    "coordinator_address": (None, "multi-host training (--coordinator_address)"),
    "num_processes": (1, "multi-host training (--num_processes)"),
    "process_id": (None, "multi-host training (--process_id)"),
    "transfer_quant": ("none", "int8 transfer (--transfer_quant)"),
    "device_prefetch": (False, "device prefetch (--device_prefetch)"),
    "profile_dir": (None, "profiling (--profile_dir)"),
    "checkpoint_every_steps": (None, "mid-epoch checkpoints (--checkpoint_every_steps)"),
    "attn_impl": ("auto", "attention implementations other than auto (--attn_impl)"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m multimodal_uncertainty_tpu_torch.train")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain attention on the CPU")
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--n_epochs", type=int, default=100)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--dataset", type=str, choices=["food101", "hateful-meme-dataset"],
                   default="hateful-meme-dataset")
    p.add_argument("--sample_size", type=int, default=None)
    p.add_argument("--framework", type=str, choices=["vilt", "flava", "mmbt"])
    p.add_argument("--model_type", type=str, default="Vanilla",
                   choices=["Vanilla", "MIMO-shuffle-instance", "MultiHead"])
    p.add_argument("--multimodal_num_attention_heads", type=int, default=3)
    p.add_argument("--multimodal_num_hidden_layers", type=int, default=3)
    p.add_argument("--clstoken", action="store_true")
    p.add_argument("--dropout", type=float, default=0)
    p.add_argument("--avg_pool", action="store_true")
    p.add_argument("--wd", type=float, default=0.001)
    p.add_argument("--n_workers", type=int, default=0)
    p.add_argument("--keep_epoch_ckpts", type=int, default=None,
                   help="retain only the newest N model_epoch_*.pt (default: keep all)")
    p.add_argument("--ece", action="store_true", help="log expected calibration error per epoch")
    for flag, (off, _) in _NOT_PORTED.items():
        if isinstance(off, bool):
            p.add_argument(f"--{flag}", action="store_true", help="not ported yet: rejected")
        else:
            p.add_argument(f"--{flag}", type=type(off) if off is not None else str, default=off,
                           help="not ported yet: rejected unless left at its default")
    return p


def _food101_labels(path: str) -> list:
    """The label list of a Food-101 ``train.jsonl``, in order of first
    appearance (the JAX package's ``get_labels_and_frequencies``)."""
    freqs = Counter()
    with open(path) as f:
        for line in f:
            if line.strip():
                label = json.loads(line)["label"]
                freqs.update(label if isinstance(label, list) else [label])
    return list(freqs.keys())


def add_conditional_args(args):
    """Dataset-derived settings (the root ``train.py::add_conditional_args``)."""
    args.datapath = os.path.join(os.environ["DATA_DIR"], args.dataset)
    if args.dataset == "food101":
        args.labels = _food101_labels(os.path.join(args.datapath, "train.jsonl"))
        args.n_classes = len(args.labels)
        args.auc = False
    else:
        args.labels = list(range(2))
        args.n_classes = 2
        args.auc = True
    if args.avg_pool and args.model_type == "Vanilla":
        raise SystemExit("avg_pool is NOT supported for Vanilla")
    return args


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.framework != "flava":
        parser.error(f"--framework {args.framework}: only flava is ported to PyTorch yet")
    for flag, (off, what) in _NOT_PORTED.items():
        if getattr(args, flag) != off:
            parser.error(f"{what} is not ported to PyTorch yet")

    from multimodal_uncertainty_tpu_torch.data.flava_encoded import get_dataset_flava
    from multimodal_uncertainty_tpu_torch.device import resolve_device
    from multimodal_uncertainty_tpu_torch.training.loop import (
        construct_default_callbacks,
        load_history,
        resume_train_state,
    )
    from multimodal_uncertainty_tpu_torch.training.trainer import Trainer
    from multimodal_uncertainty_tpu_torch.utils.seeding import set_seed
    from multimodal_uncertainty_tpu_torch.zoo import setup_flava

    device = resolve_device(args.device)  # raises without a card unless --device cpu
    args = add_conditional_args(args)
    set_seed(args.seed)
    print(args)

    train, valid, test = get_dataset_flava(args, args.datapath)
    setup = setup_flava(
        model_type=args.model_type,
        n_classes=args.n_classes,
        lr=args.lr,
        wd=args.wd,
        n_epochs=args.n_epochs,
        steps_per_epoch=len(train),
        multimodal_num_attention_heads=args.multimodal_num_attention_heads,
        multimodal_num_hidden_layers=args.multimodal_num_hidden_layers,
        dropout=args.dropout,
        clstoken=args.clstoken,
        avg_pool=args.avg_pool,
        seed=args.seed,
        device=device,
    )

    os.makedirs(args.save_path, exist_ok=True)
    history_csv = os.path.join(args.save_path, "history.csv")
    last = os.path.join(args.save_path, "model_last_epoch.pt")
    if args.resume and not os.path.exists(last):
        logger.warning("--resume: no checkpoint in %s; starting fresh", args.save_path)
        args.resume = False
    if args.resume:
        H = load_history(args.save_path) if os.path.exists(history_csv) else {"epoch": []}
        epoch_start = len(H["epoch"]) + 1
        resume_train_state(setup.model, setup.optimizer, last)
    else:
        H = {}
        if os.path.exists(history_csv):
            logger.info("Removing %s", history_csv)
            os.remove(history_csv)
        epoch_start = 1

    callbacks = construct_default_callbacks(H, args.save_path, checkpoint_monitor="val_acc",
                                            keep_epoch_ckpts=args.keep_epoch_ckpts)
    for clbk in callbacks:
        clbk.set_save_path(args.save_path)
    trainer = Trainer(setup.bundle, setup.optimizer, seed=args.seed)
    trainer.train_loop(
        train,
        valid_generator=valid,
        test_generator=test,
        steps_per_epoch=len(train),
        validation_steps=len(valid),
        test_steps=len(test),
        epochs=args.n_epochs,
        callbacks=callbacks,
        patience=args.patience,
        epoch_start=epoch_start,
        auc=args.auc,
        ece=args.ece,
    )
    return trainer


if __name__ == "__main__":
    main()
