"""Train the FLAVA-fusion classifier, MMBT or ViLT.

The port of the repo-root ``train.py --framework flava|mmbt|vilt``: the same
flags (those its three branches read), the same ``history.csv`` and
checkpoint files (as torch files of this package), and ``--resume`` from
``model_last_epoch.pt`` with the optimizer state (for MMBT and ViLT also the
accumulated gradients and the plateau scheduler). ``--fast_dw`` computes
the weight gradient of every training-mode Linear whose widths are multiples
of 128 with the hand-written dW kernel. ``--bf16`` runs FLAVA's and MMBT's
activations in bfloat16 (parameters, optimizer state and checkpoints stay
fp32), as the root CLI does; ViLT takes the flag and stays fp32, as there.
``--remat`` rematerialises FLAVA's and MMBT's blocks in training (ViLT takes
it and ignores it, as the root's vilt branch does); ``--diversity
guided|random`` adds FLAVA's ensemble-diversity term at ``--diversity_coef``.
SIGTERM stops the run at the next batch boundary with ``model_midtrain.pt``
(``--checkpoint_every_steps N`` also writes it every N batches), and
``--resume`` continues from its batch; ``--profile_dir`` traces epoch
``--profile_epoch`` with ``torch.profiler``; the console goes to
``save_path/out.log`` too. It runs on the card; pass ``--device cpu`` to run
on the CPU::

    python -m multimodal_uncertainty_tpu_torch.train --framework flava \\
        --save_path results/flava --dataset hateful-meme-dataset \\
        --model_type MIMO-shuffle-instance --lr 1e-4 --n_epochs 20
    python -m multimodal_uncertainty_tpu_torch.train --framework mmbt \\
        --save_path results/mmbt --dataset food101 --batch_size 32 --lr 5e-5
    python -m multimodal_uncertainty_tpu_torch.train --framework vilt --fast_dw \\
        --save_path results/vilt --dataset food101 --batch_size 32 --lr 3e-5 \\
        --gradient_accumulation_steps 2

Data: FLAVA reads packed shards under ``$DATA_DIR/<dataset>/flava_packed``;
MMBT and ViLT read ``$DATA_DIR/<dataset>/{train,dev,test}.jsonl`` rows
``{label, text, img}`` with the images beside them and a BERT ``vocab.txt``
(``--vocab_file``, default ``$DATA_DIR/<dataset>/vocab.txt``). Weights are
drawn from ``--seed``; ``--bert_weights`` and ``--resnet_weights`` (MMBT) and
``--vilt_weights`` (ViLT) load pretrained torch state dicts (``.pth`` /
``.bin``: BERT in HF or ``pytorch_pretrained_bert`` names, torchvision's
ResNet-152, an HF ViLT) over them before training. Batches of 64 MiB or more
reach the card from a background thread through pinned buffers and a side
stream (``training/trainer.py::move_batches``), with or without the
reference's ``--device_prefetch``, which is accepted::

    python -m multimodal_uncertainty_tpu_torch.train --framework mmbt \\
        --save_path results/mmbt --dataset food101 --batch_size 32 --lr 5e-5 \\
        --bert_weights bert-base-uncased.bin --resnet_weights resnet152.pth
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import os
import threading

logger = logging.getLogger(__name__)

# flags of the JAX package's CLI that this port does not take yet, with the
# value that means "off"
_NOT_PORTED = {
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
    "attn_impl": ("auto", "attention implementations other than auto (--attn_impl)"),
    "fast_decode": (False, "the DCT-scaled JPEG decode (--fast_decode)"),
    "batch_decode": (False, "the native batch decoder (--batch_decode)"),
}
# pretrained weight flags and the framework that reads each
_WEIGHTS = {"bert_weights": "mmbt", "resnet_weights": "mmbt", "vilt_weights": "vilt"}


def add_vestigial_args(p: argparse.ArgumentParser) -> None:
    """Flags the root CLIs keep from the reference and ignore (root
    ``train.py:20-68``); the port takes and ignores them too. ``--compile_cache``
    names an XLA compilation cache, which the port has no use for."""
    ignored = "accepted for the reference CLI's sake and ignored"
    p.add_argument("--use_gpu", action="store_true", help=ignored)
    p.add_argument("--verbose", action="store_true", help=ignored)
    p.add_argument("--embed_sz", type=int, default=300, help=ignored)
    p.add_argument("--hidden", nargs="*", type=int, default=[], help=ignored)
    p.add_argument("--hidden_sz", type=int, default=768, help=ignored)
    p.add_argument("--img_hidden_sz", type=int, default=2048, help=ignored)
    p.add_argument("--include_bn", type=int, default=True, help=ignored)
    p.add_argument("--compile_cache", type=str, default=None,
                   help="the JAX package's XLA compilation cache; the port compiles no "
                        "XLA and ignores it")


def warn_ignored(args) -> None:
    if args.compile_cache is not None:
        logger.warning("--compile_cache %s ignored: it names an XLA compilation cache and "
                       "the port compiles no XLA", args.compile_cache)


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device ('cuda', 'cuda:1', 'cpu') or a GPU index as in the "
                        "root CLIs ('0' is cuda:0); 'cpu' runs the plain attention on the CPU")


def reject_heads_without_kernel(parser, n_head: int, device) -> None:
    """FLAVA fusion's width is 768: on the card, a head count whose head dim
    has no kernel instance is a usage error, reported before any data loads."""
    from multimodal_uncertainty_tpu_torch.ops.attention import check_kernel_heads

    try:
        check_kernel_heads(768, n_head, device)
    except ValueError as e:
        parser.error(f"--multimodal_num_attention_heads: {e}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m multimodal_uncertainty_tpu_torch.train")
    add_device_arg(p)
    add_vestigial_args(p)
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
    p.add_argument("--framework", type=str, choices=["vilt", "flava", "mmbt"], required=True)
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
    # mmbt and vilt (and their scheduler)
    p.add_argument("--lr_patience", type=int, default=2)
    p.add_argument("--lr_factor", type=float, default=0.5)
    p.add_argument("--gradient_accumulation_steps", type=int, default=40)
    p.add_argument("--bert_model", type=str, default="bert-base-uncased",
                   choices=["bert-base-uncased", "bert-large-uncased"])
    p.add_argument("--drop_img_percent", type=float, default=0.0)
    p.add_argument("--freeze_img", type=int, default=3)
    p.add_argument("--freeze_txt", type=int, default=5)
    p.add_argument("--img_embed_pool_type", type=str, default="avg", choices=["max", "avg"])
    p.add_argument("--max_seq_len", type=int, default=512)
    p.add_argument("--num_image_embeds", type=int, default=3)
    p.add_argument("--warmup", type=float, default=0.1)
    p.add_argument("--vocab_file", type=str, default=None, help="local BERT vocab.txt")
    p.add_argument("--attention_probs_dropout", type=float, default=0.0,
                   help="mmbt / vilt: dropout on the attention probabilities in training "
                        "(torch BERT's 0.1); 0 keeps the JAX package's default")
    p.add_argument("--tiny", action="store_true",
                   help="mmbt: BERT of width 64, 2 layers, 2 heads and ResNet (1, 1, 1, 1); "
                        "vilt: width 64, 2 layers, 2 heads")
    p.add_argument("--fast_dw", action="store_true",
                   help="weight gradients of training-mode Linears whose widths are "
                        "multiples of 128 on the hand-written dW kernel")
    p.add_argument("--modality", type=str, default="both", choices=["both", "image", "text"],
                   help="mmbt unimodal-baseline training (keep mask)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 activations (flava/mmbt paths; vilt stays fp32)")
    p.add_argument("--bert_weights", type=str, default=None,
                   help="mmbt: a BERT state dict (.pth / .bin; HF or pytorch_pretrained_bert "
                        "names) loaded over the random weights")
    p.add_argument("--resnet_weights", type=str, default=None,
                   help="mmbt: a torchvision ResNet state dict loaded over the image encoder")
    p.add_argument("--vilt_weights", type=str, default=None,
                   help="vilt: an HF ViLT state dict (ViltForImagesAndTextClassification, "
                        "ViltForMaskedLM or ViltModel names)")
    p.add_argument("--device_prefetch", action="store_true",
                   help="accepted as the reference CLI takes it: the trainer copies batches "
                        "of 64 MiB or more to the card from a background thread (pinned "
                        "buffers, a side stream) and smaller ones as they come")
    p.add_argument("--remat", action="store_true",
                   help="rematerialise the transformer blocks, BERT layers and ResNet "
                        "bottlenecks in training (less memory; flava and mmbt, vilt ignores it)")
    p.add_argument("--diversity", type=str, default="none", choices=["none", "guided", "random"],
                   help="flava: the ensemble-diversity term added to the training loss")
    p.add_argument("--diversity_coef", type=float, default=0.1,
                   help="weight of the diversity term; read only with --diversity")
    p.add_argument("--checkpoint_every_steps", type=int, default=None,
                   help="also write the mid-epoch recovery checkpoint model_midtrain.pt every N "
                        "batches; SIGTERM writes it at the next batch boundary regardless, and "
                        "--resume continues from its batch")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of one epoch's train batches here "
                        "(epoch_<e>.pt.trace.json.gz; utils/traces.py reads it)")
    p.add_argument("--profile_epoch", type=int, default=2,
                   help="the epoch to trace (default 2: epoch 1 pays the kernels' first loads)")
    for flag, (off, _) in _NOT_PORTED.items():
        if isinstance(off, bool):
            p.add_argument(f"--{flag}", action="store_true", help="not ported yet: rejected")
        else:
            p.add_argument(f"--{flag}", type=type(off) if off is not None else str, default=off,
                           help="not ported yet: rejected unless left at its default")
    return p


@contextlib.contextmanager
def run_guards(save_path: str):
    """Around a training run: the console mirrored into ``save_path/out.log``
    and SIGTERM latched by a ``PreemptionGuard`` (installed from the main
    thread only, as CPython requires); yields the guard. Both are undone on
    the way out."""
    from multimodal_uncertainty_tpu_torch.training.preemption import PreemptionGuard
    from multimodal_uncertainty_tpu_torch.utils.logging_utils import TeeLog

    os.makedirs(save_path, exist_ok=True)
    guard = PreemptionGuard()
    if threading.current_thread() is threading.main_thread():
        guard.install()
    else:
        logger.warning("not on the main thread: SIGTERM is not latched for this run")
    tee = TeeLog(os.path.join(save_path, "out.log")).install()
    try:
        yield guard
    finally:
        tee.uninstall()
        guard.uninstall()


def resume_or_start(save_path: str, resume: bool, setup):
    """The root CLIs' resume order: ``(H, epoch_start, resume_mid)``. Without
    ``resume`` a fresh start (history.csv removed). With it and no
    checkpoint, a fresh start with a warning. A ``model_midtrain.pt`` whose
    epoch is the one history.csv resumes at is loaded (its ``mid`` blob is
    returned); one of an epoch history.csv has finished is stale and ignored;
    otherwise ``model_last_epoch.pt``."""
    from multimodal_uncertainty_tpu_torch.training.loop import (
        load_history,
        resume_midtrain_state,
        resume_train_state,
    )

    history_csv = os.path.join(save_path, "history.csv")
    last = os.path.join(save_path, "model_last_epoch.pt")
    midtrain = os.path.join(save_path, "model_midtrain.pt")
    if resume and not (os.path.exists(midtrain) or os.path.exists(last)):
        logger.warning("--resume: no checkpoint in %s; starting fresh", save_path)
        resume = False
    if not resume:
        if os.path.exists(history_csv):
            logger.info("Removing %s", history_csv)
            os.remove(history_csv)
        return {}, 1, None
    H = load_history(save_path) if os.path.exists(history_csv) else {"epoch": []}
    epoch_start = len(H["epoch"]) + 1
    state = dict(accumulator=setup.accumulator, plateau=setup.plateau)
    if os.path.exists(midtrain):
        mid = resume_midtrain_state(setup.model, setup.optimizer, midtrain, **state)
        if int(mid["epoch"]) == epoch_start:
            return H, epoch_start, mid
        logger.warning("ignoring stale %s (epoch %d; history says resume at %d)", midtrain,
                       int(mid["epoch"]), epoch_start)
    resume_train_state(setup.model, setup.optimizer, last, **state)
    return H, epoch_start, None


def add_conditional_args(args):
    """Dataset-derived settings (the root ``train.py::add_conditional_args``)."""
    from multimodal_uncertainty_tpu_torch.data.food101 import get_labels_and_frequencies

    args.datapath = os.path.join(os.environ["DATA_DIR"], args.dataset)
    if args.dataset == "food101":
        args.labels, _ = get_labels_and_frequencies(os.path.join(args.datapath, "train.jsonl"))
        args.n_classes = len(args.labels)
        args.auc = False
        args.error_cases_remover = False
    else:
        args.labels = list(range(2))
        args.n_classes = 2
        args.auc = True
        args.error_cases_remover = True
    if args.avg_pool and args.model_type == "Vanilla":
        raise SystemExit("avg_pool is NOT supported for Vanilla")
    return args


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.framework == "mmbt" and args.dataset != "food101":
        parser.error("--framework mmbt: MMBT is only supported for --dataset food101")
    for flag, (off, what) in _NOT_PORTED.items():
        if getattr(args, flag) != off:
            parser.error(f"{what} is not ported to PyTorch yet")
    for flag, framework in _WEIGHTS.items():
        if getattr(args, flag) is not None and args.framework != framework:
            parser.error(f"--{flag}: only --framework {framework} loads these weights")

    with run_guards(args.save_path) as guard:
        return _train(parser, args, guard)


def _train(parser, args, guard):
    from multimodal_uncertainty_tpu_torch.device import resolve_device
    from multimodal_uncertainty_tpu_torch.training.loop import construct_default_callbacks
    from multimodal_uncertainty_tpu_torch.training.trainer import Trainer
    from multimodal_uncertainty_tpu_torch.utils.seeding import set_seed

    warn_ignored(args)
    device = resolve_device(args.device)  # raises without a card unless --device cpu
    if args.framework == "flava":
        reject_heads_without_kernel(parser, args.multimodal_num_attention_heads, device)
    args = add_conditional_args(args)
    set_seed(args.seed)
    print(args)

    setup_fn = {"flava": _flava_setup, "mmbt": _mmbt_setup, "vilt": _vilt_setup}[args.framework]
    train, valid, test, setup = setup_fn(args, device)

    H, epoch_start, resume_mid = resume_or_start(args.save_path, args.resume, setup)
    callbacks = construct_default_callbacks(H, args.save_path, checkpoint_monitor="val_acc",
                                            keep_epoch_ckpts=args.keep_epoch_ckpts)
    for clbk in callbacks:
        clbk.set_save_path(args.save_path)
    trainer = Trainer(setup.bundle, setup.optimizer, seed=args.seed, plateau=setup.plateau,
                      accumulator=setup.accumulator)
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
        freeze_img=args.freeze_img,
        freeze_txt=args.freeze_txt,
        profile_dir=args.profile_dir,
        profile_epoch=args.profile_epoch,
        preemption=guard,
        midtrain_path=os.path.join(args.save_path, "model_midtrain.pt"),
        checkpoint_every_steps=args.checkpoint_every_steps,
        resume_mid=resume_mid,
    )
    if trainer.preempted:
        logger.warning("run preempted; restart with --resume to continue")
    return trainer


def load_sd(path):
    """A pretrained torch state dict (``.pth`` / ``.bin``) on the CPU, its
    tensors as they are stored (root ``train.py:360-369``)."""
    if path is None:
        return None
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def _flava_setup(args, device):
    import torch

    from multimodal_uncertainty_tpu_torch.data.flava_encoded import get_dataset_flava
    from multimodal_uncertainty_tpu_torch.zoo import setup_flava

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
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        fast_dw=args.fast_dw,
        remat=args.remat,
        diversity=args.diversity,
        diversity_coef=args.diversity_coef,
        device=device,
    )
    return train, valid, test, setup


def _warn_flava_only_diversity(args) -> None:
    if args.diversity != "none":
        logger.warning("--diversity %s ignored for --framework %s: the root CLI passes it to "
                       "FLAVA fusion only", args.diversity, args.framework)


def _mmbt_setup(args, device):
    """The root ``train.py`` mmbt branch (:371-451)."""
    import torch

    _warn_flava_only_diversity(args)
    from multimodal_uncertainty_tpu_torch.data.food101 import get_food101
    from multimodal_uncertainty_tpu_torch.models.bert import BertConfig
    from multimodal_uncertainty_tpu_torch.zoo import setup_mmbt

    train, valid, test, n_classes, vocab = get_food101(
        vocab_file=args.vocab_file,
        datapath=args.datapath,
        batch_size=args.batch_size,
        drop_img_percent=args.drop_img_percent,
        max_seq_len=args.max_seq_len,
        num_image_embeds=args.num_image_embeds,
        n_workers=args.n_workers,
        sample_size=args.sample_size,
        seed=args.seed,
    )
    args.n_classes = n_classes
    total_steps = len(train) / args.gradient_accumulation_steps * args.n_epochs
    if args.tiny:
        bert_cfg = dataclasses.replace(BertConfig.base(), hidden_size=64, num_hidden_layers=2,
                                       num_attention_heads=2, intermediate_size=128)
        resnet_layers = (1, 1, 1, 1)
    else:
        bert_cfg = (BertConfig.large() if args.bert_model == "bert-large-uncased"
                    else BertConfig.base())
        resnet_layers = (3, 8, 36, 3)
    if args.attention_probs_dropout > 0:
        bert_cfg = dataclasses.replace(bert_cfg,
                                       attention_probs_dropout_prob=args.attention_probs_dropout)
    setup = setup_mmbt(
        n_classes=n_classes,
        lr=args.lr,
        warmup=args.warmup,
        total_steps=total_steps,
        lr_patience=args.lr_patience,
        lr_factor=args.lr_factor,
        num_image_embeds=args.num_image_embeds,
        bert_config=bert_cfg,
        resnet_layers=resnet_layers,
        img_embed_pool_type=args.img_embed_pool_type,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        vocab_size=vocab.vocab_sz,
        modality=args.modality,
        seed=args.seed,
        dtype=torch.bfloat16 if args.bf16 else None,
        fast_dw=args.fast_dw,
        pretrained_bert_sd=load_sd(args.bert_weights),
        pretrained_resnet_sd=load_sd(args.resnet_weights),
        remat=args.remat,
        device=device,
    )
    return train, valid, test, setup


def _vilt_setup(args, device):
    """The root ``train.py`` vilt branch (:452-490): fp32, ``--bf16`` or not,
    and no rematerialisation, ``--remat`` or not."""
    if args.bf16:
        logger.warning("--bf16 ignored for --framework vilt: ViLT trains in fp32, as the "
                       "root CLI's vilt branch does")
    if args.remat:
        logger.warning("--remat ignored for --framework vilt: the root CLI's vilt branch "
                       "rematerialises nothing")
    _warn_flava_only_diversity(args)
    from multimodal_uncertainty_tpu_torch.data.vilt_data import get_dataset_vilt
    from multimodal_uncertainty_tpu_torch.models.vilt import ViltConfig
    from multimodal_uncertainty_tpu_torch.zoo import setup_vilt

    train, valid, test = get_dataset_vilt(args, args.datapath)
    cfg = None
    if args.tiny:
        cfg = dataclasses.replace(ViltConfig.b32(), hidden_size=64, num_hidden_layers=2,
                                  num_attention_heads=2, intermediate_size=128,
                                  num_labels=args.n_classes, image_size=384)
    if args.attention_probs_dropout > 0:
        cfg = dataclasses.replace(
            cfg or dataclasses.replace(ViltConfig.b32(), num_labels=args.n_classes),
            attention_probs_dropout_prob=args.attention_probs_dropout)
    setup = setup_vilt(
        n_classes=args.n_classes,
        lr=args.lr,
        lr_patience=args.lr_patience,
        lr_factor=args.lr_factor,
        vilt_config=cfg,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        seed=args.seed,
        fast_dw=args.fast_dw,
        pretrained_vilt_sd=load_sd(args.vilt_weights),
        device=device,
    )
    return train, valid, test, setup


if __name__ == "__main__":
    main()
