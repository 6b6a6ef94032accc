"""Default callbacks, ``history.csv`` persistence and resume (port of
``training/loop.py:34-102,244-317``), the mid-epoch resume included.

The experiment record is the reference's: per-epoch history rows appended to
an in-memory dict ``H`` and written to ``history.csv`` (one column per key, in
insertion order, no index), the best-val checkpoint ``model_best_val.pt``,
per-epoch ``model_epoch_{e}.pt`` and the rolling ``model_last_epoch.pt``.
Written with the ``csv`` module (the card's host has no pandas).
"""
from __future__ import annotations

import csv
import logging
import os
import re
from functools import partial

import numpy as np
import torch

from multimodal_uncertainty_tpu_torch.training.callbacks import (
    Callback,
    LambdaCallback,
    ModelCheckpoint,
)
from multimodal_uncertainty_tpu_torch.training.checkpoint import (
    enqueue_after_writes,
    load_weights,
    restore_into,
    save_weights,
)

logger = logging.getLogger(__name__)

TYPES_TO_SAVE_IN_CSV = (int, float, complex, np.integer, np.floating, str)


def _append_to_history_csv(epoch, logs, H):
    for key, value in logs.items():
        H.setdefault(key, []).append(value)


def _save_history_csv(epoch, logs, save_path, H):
    logger.info("".join(f"{k}={v}\t" for k, v in logs.items()
                        if isinstance(v, TYPES_TO_SAVE_IN_CSV)))
    path = os.path.join(save_path, "history.csv")
    logger.info("Saving history to %s", path)
    cols = {k: v for k, v in H.items() if v and isinstance(v[-1], TYPES_TO_SAVE_IN_CSV)}
    lengths = {len(v) for v in cols.values()}
    if len(lengths) > 1:
        raise ValueError(f"history columns differ in length: {sorted(lengths)}")
    tmp = path + ".tmp"
    with open(tmp, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(list(cols))
        writer.writerows(zip(*cols.values()))
    os.replace(tmp, path)


def _parse(value: str):
    for kind in (int, float):
        try:
            return kind(value)
        except ValueError:
            pass
    return value


def load_history(save_path: str) -> dict:
    """Replay history.csv into the H dict for --resume."""
    with open(os.path.join(save_path, "history.csv"), newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {col: [_parse(r[i]) for r in body] for i, col in enumerate(header)}


class _SaveEveryEpoch(Callback):
    def __init__(self, save_path, keep_epoch_ckpts=None):
        self.dir = save_path
        self.keep = keep_epoch_ckpts

    def on_epoch_end(self, epoch, logs):
        logger.info("Saving model from epoch %s", epoch)
        model_state, opt_state = self.trainer.checkpointable_state()
        save_weights(model_state, opt_state, os.path.join(self.dir, f"model_epoch_{epoch}.pt"))
        save_weights(model_state, opt_state, os.path.join(self.dir, "model_last_epoch.pt"))
        if self.keep is not None:  # after this epoch's queued writes
            enqueue_after_writes(partial(prune_epoch_checkpoints, self.dir, self.keep))


def construct_default_callbacks(H, save_path, checkpoint_monitor="val_acc",
                                keep_epoch_ckpts=None):
    """History rows, history.csv, the best-val checkpoint and the per-epoch
    checkpoints. ``keep_epoch_ckpts=N`` keeps only the newest N
    ``model_epoch_{e}.pt`` (best and last are never pruned)."""
    return [
        LambdaCallback(on_epoch_end=partial(_append_to_history_csv, H=H)),
        LambdaCallback(on_epoch_end=partial(_save_history_csv, save_path=save_path, H=H)),
        ModelCheckpoint(monitor=checkpoint_monitor, save_best_only=True, mode="max",
                        filepath=os.path.join(save_path, "model_best_val.pt")),
        _SaveEveryEpoch(save_path, keep_epoch_ckpts),
    ]


def prune_epoch_checkpoints(save_path: str, keep: int) -> list:
    """Delete all but the newest ``keep`` ``model_epoch_{e}.pt`` files (by
    epoch number). Returns the removed paths."""
    found = sorted(
        (int(m.group(1)), name) for name in os.listdir(save_path)
        if (m := re.fullmatch(r"model_epoch_(\d+)\.pt", name))
    )
    removed = []
    for _, name in found[: max(0, len(found) - keep)]:
        path = os.path.join(save_path, name)
        os.remove(path)
        removed.append(path)
    return removed


def resume_train_state(model: torch.nn.Module, optimizer, checkpoint_path: str, *,
                       accumulator=None, plateau=None) -> None:
    """Full resume in place: the model's weights (BatchNorm statistics
    included) and, when the checkpoint has them, the optimizer's moments,
    steps and lr scale, the accumulated gradients with the micro-step count,
    and the plateau scheduler's state."""
    _resume(model, optimizer, load_weights(checkpoint_path), checkpoint_path,
            accumulator=accumulator, plateau=plateau)


def resume_midtrain_state(model: torch.nn.Module, optimizer, checkpoint_path: str, *,
                          accumulator=None, plateau=None) -> dict:
    """Resume in place from a mid-epoch checkpoint (``model_midtrain.pt``,
    written on SIGTERM or by ``--checkpoint_every_steps``;
    ``training/preemption.py``) and return its ``mid`` blob: the interrupted
    ``epoch``, ``next_batch``, the epoch's ``loss_sum``, ``metric_sums`` and
    ``size_sum``, and ``acc100_counter``, for ``Trainer.train_loop(
    resume_mid=...)``. A checkpoint without the blob is refused before the
    model is touched."""
    loaded = load_weights(checkpoint_path)
    mid = loaded[1].get("mid") if isinstance(loaded[1], dict) else None
    if mid is None:
        raise ValueError(f"{checkpoint_path} is not a mid-epoch checkpoint (no 'mid' blob)")
    _resume(model, optimizer, loaded, checkpoint_path, accumulator=accumulator, plateau=plateau)
    return mid


def _resume(model, optimizer, loaded, checkpoint_path, *, accumulator, plateau) -> None:
    model_sd, opt_sd = loaded
    restore_into(model, model_sd)
    if not opt_sd:
        return
    optimizer.load_state_dict(opt_sd["opt_state"])
    if accumulator is not None:
        accumulator.load_state_dict(int(opt_sd["step"]), opt_sd["accum_grads"])
    elif int(opt_sd["step"]) != optimizer.step:
        raise ValueError(f"{checkpoint_path}: train step {int(opt_sd['step'])} differs "
                         f"from the optimizer's {optimizer.step}")
    if plateau is not None and "scheduler" in opt_sd:
        plateau.load_state_dict(opt_sd["scheduler"])
