"""Train the FashionMNIST round's MIMO ResNet or MIMO transformer.

The port of the repo-root ``train_fashionmnist.py``: the same flags, the same
``history.csv`` and checkpoint files (as torch files of this package), and
``--resume`` from ``model_last_epoch.pt`` with the optimizer's and the plateau
scheduler's state. The reference's quirk is kept: a run trains
``--n_epochs - 1`` epochs. It runs on the card; pass ``--device cpu`` to run
on the CPU::

    python -m multimodal_uncertainty_tpu_torch.train_fashionmnist \\
        --save_path results/fmnist --model_type MIMO-shuffle-instance --n_epochs 100
    python -m multimodal_uncertainty_tpu_torch.train_fashionmnist --transformer \\
        --save_path results/fmnist_tf --model_type MIMO-shuffle-instance --lr 1e-4

Data: the idx-ubyte files under ``$DATA_DIR/FashionMNIST/raw``
(``data/fmnist.py``); ``--synthetic`` (or missing files) trains on the seeded
stand-in. The MIMO ResNet trains with SGD and the plateau on val_loss, the
transformer (MultiHead or MIMO-shuffle-instance, 768 wide) with BertAdam and
the plateau on val_acc; on the card its head count must have a kernel
instance (``--multimodal_num_attention_heads`` 1, 2, 3, 4, 6, 8, 12, 16, 24
or 32). ``--use_gpu`` and ``--verbose`` are taken and ignored. Not ported yet
(ROADMAP Queue 1, items 6 and 7): ``--diversity``, ``--profile_dir``,
``--attn_impl`` other than auto (rejected), and the mid-epoch checkpoint
``model_midtrain.pt``, preemption and ``out.log``.
"""
from __future__ import annotations

import argparse
import logging
import os

logger = logging.getLogger(__name__)

# flags of the root CLI that this port does not take yet, with the value that means "off"
_NOT_PORTED = {
    "diversity": ("none", "diversity training (--diversity)"),
    "profile_dir": (None, "profiling (--profile_dir, --profile_epoch)"),
    "profile_epoch": (2, "profiling (--profile_dir, --profile_epoch)"),
    "attn_impl": ("auto", "attention implementations other than auto (--attn_impl)"),
}


def build_parser() -> argparse.ArgumentParser:
    from multimodal_uncertainty_tpu_torch.ops.data_forming import MULTIVIEW_MODEL_TYPES
    from multimodal_uncertainty_tpu_torch.train import add_device_arg

    ignored = "accepted for the reference CLI's sake and ignored"
    p = argparse.ArgumentParser(
        prog="python -m multimodal_uncertainty_tpu_torch.train_fashionmnist",
        description="Train Models")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--wd", type=float, default=0.001)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--n_epochs", type=int, default=100)
    p.add_argument("--model_type", type=str, default="Vanilla", choices=MULTIVIEW_MODEL_TYPES)
    p.add_argument("--use_gpu", action="store_true", help=ignored)
    add_device_arg(p)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--verbose", action="store_true", help=ignored)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--keep_epoch_ckpts", type=int, default=None,
                   help="retain only the newest N model_epoch_*.pt (default: keep all)")
    p.add_argument("--multimodal_num_attention_heads", type=int, default=3)
    p.add_argument("--multimodal_num_hidden_layers", type=int, default=3)
    p.add_argument("--transformer", action="store_true")
    p.add_argument("--warmup", type=float, default=0.1)
    p.add_argument("--dropout", type=float, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="train on the seeded synthetic FashionMNIST stand-in")
    p.add_argument("--sample_size", type=int, default=None)
    p.add_argument("--diversity_coef", type=float, default=0.1,
                   help="weight of the diversity loss; read only with --diversity, which is "
                        "not ported yet, so ignored")
    p.add_argument("--ece", action="store_true",
                   help="record val/test expected calibration error per epoch in history.csv")
    for flag, (off, _) in _NOT_PORTED.items():
        p.add_argument(f"--{flag}", type=type(off) if off is not None else str, default=off,
                       help="not ported yet: rejected unless left at its default")
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    for flag, (off, what) in _NOT_PORTED.items():
        if getattr(args, flag) != off:
            parser.error(f"{what} is not ported to PyTorch yet")
    if args.transformer and args.model_type not in ("MultiHead", "MIMO-shuffle-instance"):
        parser.error("--transformer takes --model_type MultiHead or MIMO-shuffle-instance")

    from multimodal_uncertainty_tpu_torch.data.fmnist import get_fmnist
    from multimodal_uncertainty_tpu_torch.device import resolve_device
    from multimodal_uncertainty_tpu_torch.train import reject_heads_without_kernel
    from multimodal_uncertainty_tpu_torch.training.loop import (
        construct_default_callbacks,
        load_history,
        resume_train_state,
    )
    from multimodal_uncertainty_tpu_torch.training.trainer import Trainer
    from multimodal_uncertainty_tpu_torch.utils.seeding import set_seed
    from multimodal_uncertainty_tpu_torch.zoo import setup_fashionmnist

    device = resolve_device(args.device)  # raises without a card unless --device cpu
    if args.transformer:
        reject_heads_without_kernel(parser, args.multimodal_num_attention_heads, device)
    set_seed(args.seed)
    print(args)

    train, valid, _ = get_fmnist(datapath=os.environ.get("DATA_DIR"), batch_size=args.batch_size,
                                 shuffle=True, seed=args.seed, sample_size=args.sample_size,
                                 synthetic=args.synthetic)
    setup = setup_fashionmnist(
        model_type=args.model_type,
        transformer=args.transformer,
        lr=args.lr,
        wd=args.wd,
        momentum=args.momentum,
        warmup=args.warmup,
        total_steps=len(train) * args.n_epochs,
        multimodal_num_attention_heads=args.multimodal_num_attention_heads,
        multimodal_num_hidden_layers=args.multimodal_num_hidden_layers,
        dropout=args.dropout,
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
        resume_train_state(setup.model, setup.optimizer, last, plateau=setup.plateau)
    else:
        H = {}
        if os.path.exists(history_csv):
            os.remove(history_csv)
        epoch_start = 1

    callbacks = construct_default_callbacks(H, args.save_path, checkpoint_monitor="val_acc",
                                            keep_epoch_ckpts=args.keep_epoch_ckpts)
    for clbk in callbacks:
        clbk.set_save_path(args.save_path)
    trainer = Trainer(setup.bundle, setup.optimizer, seed=args.seed, plateau=setup.plateau,
                      size_fn=setup.size_fn)
    trainer.train_loop(
        train,
        valid_generator=valid,
        test_generator=valid,
        steps_per_epoch=len(train),
        validation_steps=len(valid),
        test_steps=len(valid),
        epochs=args.n_epochs - 1,  # the reference's quirk: n_epochs - 1 epochs (:184)
        callbacks=callbacks,
        patience=args.patience,
        epoch_start=epoch_start,
        ece=args.ece,
        scheduler_metric=setup.scheduler_metric,
    )
    return trainer


if __name__ == "__main__":
    main()
