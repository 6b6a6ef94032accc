"""MMBT robustness sweep over a trained checkpoint of this package.

The port of the repo-root ``eval_mmbt_robustness.py``: the same flags, the
same ``robustness_{ckpt}_predictions_{phase}.npy`` (S, 3 + 2R, C) float32 and
``robustness_{ckpt}_labels_{phase}.npy`` files, and the same two summary
lines. It runs on the card; pass ``--device cpu`` to run on the CPU::

    python -m multimodal_uncertainty_tpu_torch.eval_mmbt_robustness \\
        --save_path results/mmbt --phase dev --batch_size 32 \\
        --checkpoint_path results/mmbt/model_best_val.pt \\
        --dataset food101 --datapath $DATA_DIR/food101

Data: a Food-101 tree (``{train,dev,test}.jsonl``, the images, a BERT
``vocab.txt``) under ``--datapath``, default ``$DATA_DIR`` as in the root
CLI; ``--phase`` is train, dev or test, and ``val`` is an alias of ``dev``.
The checkpoint is a torch file of this package's MMBT train CLI, with the
same ``--bert_model`` / ``--tiny``, ``--num_image_embeds`` and
``--img_embed_pool_type``. ``--data_parallel`` above 1 (a mesh sweep) is not
ported.
"""
from __future__ import annotations

import argparse
import dataclasses


def build_parser() -> argparse.ArgumentParser:
    from multimodal_uncertainty_tpu_torch.train import add_device_arg, add_vestigial_args

    p = argparse.ArgumentParser(
        prog="python -m multimodal_uncertainty_tpu_torch.eval_mmbt_robustness",
        description="Eval Models")
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--phase", type=str, required=True, choices=["train", "val", "dev", "test"])
    p.add_argument("--batch_size", type=int, required=True)
    p.add_argument("--checkpoint_path", type=str, required=True)
    add_device_arg(p)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--n_repeats", type=int, default=20)
    p.add_argument("--dataset", type=str, choices=["food101", "hateful-meme-dataset"],
                   default="hateful-meme-dataset")
    p.add_argument("--num_image_embeds", type=int, default=3)
    p.add_argument("--drop_img_percent", type=float, default=0.0)
    p.add_argument("--dropout", type=float, default=0.1,
                   help="accepted for the reference CLI's sake; the sweep runs in eval mode")
    p.add_argument("--datapath", type=str, default=None,
                   help="the Food-101 tree (default: $DATA_DIR)")
    p.add_argument("--bert_model", type=str, default="bert-base-uncased",
                   choices=["bert-base-uncased", "bert-large-uncased"])
    p.add_argument("--max_seq_len", type=int, default=512)
    p.add_argument("--n_workers", type=int, default=0)
    p.add_argument("--img_embed_pool_type", type=str, default="avg", choices=["max", "avg"])
    p.add_argument("--vocab_file", type=str, default=None)
    p.add_argument("--sample_size", type=int, default=None)
    p.add_argument("--tiny", action="store_true",
                   help="BERT of width 64, 2 layers, 2 heads and ResNet (1, 1, 1, 1)")
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
    from multimodal_uncertainty_tpu_torch.train import warn_ignored

    warn_ignored(args)
    device = resolve_device(args.device)  # raises without a card unless --device cpu

    from multimodal_uncertainty_tpu_torch.data.food101 import get_food101
    from multimodal_uncertainty_tpu_torch.evals.robustness_mmbt import mmbt_robustness_sweep
    from multimodal_uncertainty_tpu_torch.models.bert import BertConfig
    from multimodal_uncertainty_tpu_torch.training.loop import resume_train_state
    from multimodal_uncertainty_tpu_torch.zoo import setup_mmbt

    train, val, test, n_classes, vocab = get_food101(
        vocab_file=args.vocab_file,
        datapath=args.datapath,
        batch_size=args.batch_size,
        drop_img_percent=args.drop_img_percent,
        max_seq_len=args.max_seq_len,
        num_image_embeds=args.num_image_embeds,
        n_workers=args.n_workers,
        sample_size=args.sample_size,
    )
    # the reference names the splits train/dev/test; 'val' is the same split as 'dev'
    data = {"train": train, "val": val, "dev": val, "test": test}

    if args.tiny:
        bert_cfg = dataclasses.replace(BertConfig.base(), hidden_size=64, num_hidden_layers=2,
                                       num_attention_heads=2, intermediate_size=128)
        resnet_layers = (1, 1, 1, 1)
    else:
        bert_cfg = (BertConfig.large() if args.bert_model == "bert-large-uncased"
                    else BertConfig.base())
        resnet_layers = (3, 8, 36, 3)
    setup = setup_mmbt(
        n_classes=n_classes,
        num_image_embeds=args.num_image_embeds,
        bert_config=bert_cfg,
        resnet_layers=resnet_layers,
        img_embed_pool_type=args.img_embed_pool_type,
        gradient_accumulation_steps=1,
        vocab_size=vocab.vocab_sz,
        seed=args.seed,
        device=device,
    )
    resume_train_state(setup.model, setup.optimizer, args.checkpoint_path,
                       accumulator=setup.accumulator, plateau=setup.plateau)

    ckpt_name = args.checkpoint_path.split("/")[-1].split(".")[0]
    preds, labels = mmbt_robustness_sweep(
        setup.model,
        data[args.phase],
        num_image_embeds=args.num_image_embeds,
        n_repeats=args.n_repeats,
        seed=args.seed,
        save_path=args.save_path,
        checkpoint_name=ckpt_name,
        phase=args.phase,
    )
    s, m, c = preds.shape
    print("Gathered predictions of {} samples, {} variants, {} classes".format(s, m, c))
    print("Gathered labels of {} samples".format(len(labels)))
    return preds, labels


if __name__ == "__main__":
    main()
