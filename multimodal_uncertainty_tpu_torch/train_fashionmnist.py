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
or 32). ``--diversity guided|random`` adds the ensemble-diversity term at
``--diversity_coef``; ``--profile_dir`` traces epoch ``--profile_epoch``
with ``torch.profiler``. SIGTERM stops the run at the next batch boundary with
``model_midtrain.pt`` and ``--resume`` continues from its batch; the console
goes to ``save_path/out.log`` too. ``--use_gpu`` and ``--verbose`` are taken
and ignored; ``--attn_impl`` other than auto is rejected.
"""
from __future__ import annotations

import argparse
import logging
import os

logger = logging.getLogger(__name__)

# flags of the root CLI that this port does not take yet, with the value that means "off"
_NOT_PORTED = {
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
    p.add_argument("--diversity", type=str, default="none", choices=["none", "guided", "random"],
                   help="the ensemble-diversity term added to the training loss")
    p.add_argument("--diversity_coef", type=float, default=0.1,
                   help="weight of the diversity term; read only with --diversity")
    p.add_argument("--ece", action="store_true",
                   help="record val/test expected calibration error per epoch in history.csv")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of one epoch's train batches here")
    p.add_argument("--profile_epoch", type=int, default=2, help="the epoch to trace")
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

    from multimodal_uncertainty_tpu_torch.train import run_guards

    with run_guards(args.save_path) as guard:
        return _train(parser, args, guard)


def _train(parser, args, guard):
    from multimodal_uncertainty_tpu_torch.data.fmnist import get_fmnist
    from multimodal_uncertainty_tpu_torch.device import resolve_device
    from multimodal_uncertainty_tpu_torch.train import reject_heads_without_kernel, resume_or_start
    from multimodal_uncertainty_tpu_torch.training.loop import construct_default_callbacks
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
        diversity=args.diversity,
        diversity_coef=args.diversity_coef,
        seed=args.seed,
        device=device,
    )

    H, epoch_start, resume_mid = resume_or_start(args.save_path, args.resume, setup)
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
        profile_dir=args.profile_dir,
        profile_epoch=args.profile_epoch,
        preemption=guard,
        midtrain_path=os.path.join(args.save_path, "model_midtrain.pt"),
        resume_mid=resume_mid,
    )
    if trainer.preempted:
        logger.warning("run preempted; restart with --resume to continue")
    return trainer


if __name__ == "__main__":
    main()
