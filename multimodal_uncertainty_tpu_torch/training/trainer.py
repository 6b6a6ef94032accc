"""The epoch loop (port of ``training/trainer.py:72-510``).

Behaviour kept from the JAX package:
 - size-weighted running means of loss and metrics;
 - train metrics on the train head layout, eval metrics on the head mean;
 - ``{phase}_loss`` / ``{phase}_{metric}`` / ``{phase}_auc`` / ``{phase}_ece``
   result keys, AUROC and ECE on the host from the gathered head-mean preds;
 - a NaN train loss stops training at the epoch's end;
 - early stopping counts epochs with train acc == 100, stopping after
   ``patience`` of them;
 - the MIMO permutations of epoch e, batch i come from a generator seeded by
   (seed, 1, e, i), a pure function of the run's seed as the JAX trainer's
   folded key is; so does the randomness of a model with an ``apply_fn``
   (MMBT's dropouts);
 - MMBT's freeze flags ``(epoch < freeze_img, epoch < freeze_txt)`` with
   1-based epochs, gradient accumulation across epochs, and the plateau
   scheduler stepped each epoch on ``scheduler_metric`` (val_acc unless the
   setup names another: the MIMO ResNet's val_loss), writing the optimizer's
   ``lr_scale``;
 - a batch's weight in the running means is ``size_fn(x, y)`` on the batch
   as loaded (``len(y)`` by default; weight-sharing counts its 4 views).
Batches reach the device through ``move_batches``: large ones through
``data/loaders.py::prefetch_to_device`` (a background thread; on CUDA pinned
buffers and a side stream, the JAX package's ``--device_prefetch`` path),
small ones one at a time on the loop's thread.

Operations (``training/trainer.py:235-460`` there): ``profile_dir`` traces the
train batches of epoch ``profile_epoch`` with ``torch.profiler`` (CPU and, on
the card, CUDA activity; each step a ``train_step`` range) into
``{profile_dir}/epoch_{e}.pt.trace.json.gz``, which ``utils/traces.py`` reads
(on the card the trace opens with ``prime_profile``'s primer kernels);
``preemption`` (a ``PreemptionGuard``) is polled between batches, and once it
triggers the loop writes ``midtrain_path`` and returns with ``preempted``
set; ``checkpoint_every_steps`` writes the same file every N batches;
``resume_mid`` re-enters an interrupted epoch at its next batch with its
running sums. Left out (listed in ROADMAP): meshes.

The per-batch loss and metrics stay on the device; the loop reads them
once an epoch (and at each mid-epoch checkpoint). An epoch's weighted sums
run in float64 batch by batch, so a resumed epoch's means equal the
uninterrupted one's bit for bit.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import os
import timeit
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from multimodal_uncertainty_tpu_torch.data.loaders import flat_batch, prefetch_to_device
from multimodal_uncertainty_tpu_torch.ops.metrics import (
    binary_auroc,
    expected_calibration_error,
    softmax_np,
)
from multimodal_uncertainty_tpu_torch.training import steps as _steps
from multimodal_uncertainty_tpu_torch.training.callbacks import (
    CallbackList,
    ProgressionCallback,
    ValidationProgressionCallback,
)
from multimodal_uncertainty_tpu_torch.training.checkpoint import (
    enqueue_after_writes,
    flush_pending_writes,
    save_weights,
)
from multimodal_uncertainty_tpu_torch.utils.seeding import derived_generator


def _epoch_iterator(generator, epoch: int, start_batch: int = 0):
    """Loaders with ``iter_epoch`` shuffle statelessly by epoch and start at
    any batch; another iterable skips ``start_batch`` batches."""
    if hasattr(generator, "iter_epoch"):
        return generator.iter_epoch(epoch, start_batch)
    return itertools.islice(iter(generator), start_batch, None)


# In a process that has worked on the card for a while, a new profile session loses its first
# device records, up to ~50 at a time and once all of a 256-launch primer (seen with torch 2.11
# and CUDA 12.8 on the H100; a fresh process loses none), so a session on the card opens with
# this many kernels of its own, the primer, launched in rounds of PROFILE_PRIMER_ROUND
PROFILE_PRIMER, PROFILE_PRIMER_ROUND = 1024, 128
# the primer's kernel, in the trace's kernel names: no path of the package launches it
PROFILE_PRIMER_KERNEL = "_assert_async_cuda_kernel"


def prime_profile(device: torch.device) -> None:
    """Launch the primer into a started profile session on the card:
    ``PROFILE_PRIMER`` launches of ``torch._assert_async`` on a true scalar
    (``PROFILE_PRIMER_KERNEL``, a kernel that reads one byte), waiting for the
    card after each round. The records a session loses are the first ones, so
    they are the primer's; a trace that still holds a primer record holds
    every record after it. Nothing on the CPU."""
    if device.type != "cuda":
        return
    true = torch.ones((), dtype=torch.bool, device=device)
    for _ in range(PROFILE_PRIMER // PROFILE_PRIMER_ROUND):
        for _ in range(PROFILE_PRIMER_ROUND):
            torch._assert_async(true)
        torch.cuda.synchronize(device)


def start_profile(device: torch.device):
    """A started ``torch.profiler`` session: CPU activity, and CUDA's on the
    card, where it opens with :func:`prime_profile`'s primer."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    prime_profile(device)
    return prof


def stop_profile(prof, device: torch.device, path: str) -> None:
    """Stop ``prof`` once the card has run what was queued, and write its
    Chrome trace to ``path`` (gzipped)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)


class _EpochSums:
    """An epoch's size-weighted sums of the train loss and metrics: the
    per-batch device scalars and sizes, read on demand and added batch by
    batch in float64 onto the sums a resumed epoch starts from."""

    def __init__(self, n_metrics: int, mid: Optional[dict] = None):
        self.losses, self.metric_vals, self.sizes = [], [], []
        if mid is None:
            self.base = (0.0, np.zeros(n_metrics, np.float64), 0.0)
        else:
            self.base = (float(mid["loss_sum"]), np.asarray(mid["metric_sums"], np.float64),
                         float(mid["size_sum"]))

    def add(self, loss, metric_vals, size) -> None:
        self.losses.append(loss)
        self.metric_vals.extend(metric_vals)
        self.sizes.append(size)

    def totals(self):
        loss_sum, metric_sums, size_sum = self.base[0], self.base[1].copy(), self.base[2]
        if not self.sizes:
            return loss_sum, metric_sums, size_sum
        losses = _host(self.losses)
        mv = (_host(self.metric_vals).reshape(len(self.sizes), -1) if self.metric_vals
              else np.zeros((len(self.sizes), 0)))
        for loss, row, size in zip(losses, mv, self.sizes):
            loss_sum += loss * size
            metric_sums += row * size
            size_sum += size
        return loss_sum, metric_sums, size_sum


# the bytes of a batch from which ``move_batches`` takes the prefetcher
PREFETCH_MIN_BYTES = 64 << 20


def move_batches(batches, device):
    """The loader's ``(x, y)`` batches as tensors on ``device``. Where the
    first batch holds ``PREFETCH_MIN_BYTES`` or more (FLAVA's fp32
    embeddings, 126-290 MB a batch) they come through
    ``loaders.prefetch_to_device``, whose thread takes the pageable copies off
    the loop's path; smaller ones (MMBT's 5 MB of uint8, ViLT's 52 MB) are
    copied as they come by ``steps.to_device``, where the prefetcher's thread
    cost the loop more host time than the copies it saved (the batch movers
    in PERF.md)."""
    batches = iter(batches)
    first = next(batches, None)
    if first is None:
        return
    batches = itertools.chain([first], batches)
    if sum(np.asarray(a).nbytes for a in flat_batch(first)) >= PREFETCH_MIN_BYTES:
        yield from prefetch_to_device(batches, device)
    else:
        for batch in batches:
            yield _steps.to_device(batch, device)


def _host(values: list) -> np.ndarray:
    """Device scalars -> one float64 array (one sync)."""
    return torch.stack([torch.as_tensor(v, dtype=torch.float32) for v in values]).cpu().numpy(
    ).astype(np.float64)


class Trainer:
    def __init__(
        self,
        bundle: _steps.ModelBundle,
        optimizer,
        *,
        seed: int,
        verbose: bool = True,
        plateau=None,
        accumulator: Optional[_steps.GradAccumulator] = None,
        size_fn: Optional[Callable] = None,
    ):
        self.bundle = bundle
        self.size_fn = size_fn or (lambda x, y: len(y))
        self.optimizer = optimizer
        self.seed = seed
        self.metrics_names = [name for name, _ in bundle.metric_fns]
        self.verbose = verbose
        self.plateau = plateau
        self.accumulator = accumulator
        self.device = next(bundle.model.parameters()).device

    def checkpointable_state(self):
        """(model state dict, optimizer entry) for ``save_weights``: the JAX
        trainer's layout, with the accumulated gradients and the plateau
        scheduler's state where the run has them."""
        step = self.accumulator.step if self.accumulator is not None else self.optimizer.step
        opt = {"opt_state": self.optimizer.state_dict(),
               "step": torch.tensor(step, dtype=torch.int64)}
        if self.accumulator is not None:
            opt["accum_grads"] = dict(self.accumulator.grads)
        if self.plateau is not None:
            opt["scheduler"] = self.plateau.state_dict()
        return self.bundle.model.state_dict(), opt

    def generator(self, epoch: int, batch: int) -> torch.Generator:
        return derived_generator(self.seed, 1, epoch, batch)

    def eval_loop(self, generator: Iterable, phase: str, *, steps: Optional[int] = None,
                  auc: bool = False, ece: bool = False) -> dict:
        n_steps = len(generator) if steps is None else steps
        callback = ValidationProgressionCallback(
            phase=phase, steps=n_steps, metrics_names=["loss"] + self.metrics_names)
        losses, metric_vals, sizes = [], [], []
        preds_all, labels_all = [], []
        for batch_ind, (x, y) in zip(range(1, n_steps + 1), move_batches(generator, self.device)):
            batch_begin_time = timeit.default_timer()
            if self.verbose:
                callback.on_batch_begin(batch_ind, {})
            size = self.size_fn(x, y)
            logs, preds, labels = _steps.eval_step(self.bundle, x, y)
            losses.append(logs["loss"])
            metric_vals.extend(logs[m] for m in self.metrics_names)
            sizes.append(size)
            if auc or ece:
                preds_all.append(preds)
                labels_all.append(labels)
            if self.verbose:
                callback.on_batch_end(batch_ind, {
                    "batch": batch_ind, "size": size, "batch_begin_time": batch_begin_time,
                    **{k: v for k, v in logs.items()},
                })
        if not losses:  # an empty phase reports zeros
            return {f"{phase}_loss": 0.0, **{f"{phase}_{m}": 0.0 for m in self.metrics_names}}
        sizes_np = np.asarray(sizes, np.float64)
        info = {f"{phase}_loss": float((_host(losses) * sizes_np).sum() / sizes_np.sum())}
        if self.metrics_names:
            mv = _host(metric_vals).reshape(len(sizes), len(self.metrics_names))
            weighted = (mv * sizes_np[:, None]).sum(0) / sizes_np.sum()
            info.update({f"{phase}_{m}": float(v) for m, v in zip(self.metrics_names, weighted)})
        if auc or ece:
            preds = torch.cat(preds_all).float().cpu().numpy()
            labels = torch.cat(labels_all).cpu().numpy().reshape(-1)
            if auc:
                info[f"{phase}_auc"] = binary_auroc(labels, preds[:, 1])
            if ece:
                info[f"{phase}_ece"] = expected_calibration_error(softmax_np(preds), labels)
        return info

    def _save_midtrain(self, path: str, epoch: int, next_batch: int, sums: _EpochSums,
                       counter: int) -> None:
        """``model_midtrain.pt``: the train state and the ``mid`` blob."""
        loss_sum, metric_sums, size_sum = sums.totals()
        model_state, opt = self.checkpointable_state()
        opt["mid"] = {
            "epoch": torch.tensor(epoch, dtype=torch.int64),
            "next_batch": torch.tensor(next_batch, dtype=torch.int64),
            "loss_sum": torch.tensor(loss_sum, dtype=torch.float64),
            "metric_sums": torch.tensor(metric_sums, dtype=torch.float64),
            "size_sum": torch.tensor(size_sum, dtype=torch.float64),
            "acc100_counter": torch.tensor(counter, dtype=torch.int64),
        }
        save_weights(model_state, opt, path)

    def train_loop(
        self,
        train_generator,
        test_generator=None,
        valid_generator=None,
        *,
        epochs: int = 1000,
        steps_per_epoch: Optional[int] = None,
        validation_steps: Optional[int] = None,
        test_steps: Optional[int] = None,
        patience: int = 10,
        callbacks: Sequence = (),
        epoch_start: int = 1,
        auc: bool = False,
        ece: bool = False,
        freeze_img: int = 0,
        freeze_txt: int = 0,
        scheduler_metric: str = "val_acc",
        profile_dir: Optional[str] = None,
        profile_epoch: int = 2,
        preemption=None,
        midtrain_path: Optional[str] = None,
        checkpoint_every_steps: Optional[int] = None,
        resume_mid: Optional[dict] = None,
    ):
        """Train ``epochs``; see the module's docstring. On preemption the
        mid-epoch state goes to ``midtrain_path``, the queued writes are
        flushed and the loop returns with ``self.preempted`` True; a signal
        on an epoch's last batch saves with the train phase complete
        (``next_batch`` = the epoch's steps), so the resumed run goes on with
        the epoch's evals."""
        callback_list = CallbackList(list(callbacks))
        if self.verbose:
            callback_list.append(ProgressionCallback())
        callback_list.set_params({"epochs": epochs, "steps": steps_per_epoch})
        callback_list.set_trainer(self)

        stopped_epoch, counter, stop_training = 0, 0, False
        self.preempted = False
        if resume_mid is not None:
            counter = int(resume_mid["acc100_counter"])
        callback_list.on_train_begin({})
        for epoch in range(epoch_start, epochs + 1):
            flags = ((epoch < freeze_img, epoch < freeze_txt)
                     if self.bundle.frozen_fn is not None else None)
            callback_list.on_epoch_begin(epoch, {})
            epoch_begin_time = timeit.default_timer()
            n_steps = steps_per_epoch if steps_per_epoch is not None else len(train_generator)
            start_batch, sums = 0, _EpochSums(len(self.metrics_names))
            if resume_mid is not None and int(resume_mid["epoch"]) == epoch:
                start_batch = int(resume_mid["next_batch"])
                sums = _EpochSums(len(self.metrics_names), resume_mid)
                resume_mid = None
            prof = (start_profile(self.device)
                    if profile_dir is not None and epoch == profile_epoch else None)
            preempted_at = None
            batches = move_batches(_epoch_iterator(train_generator, epoch, start_batch),
                                   self.device)
            try:
                for batch_ind, (x, y) in zip(range(start_batch + 1, n_steps + 1), batches):
                    batch_begin_time = timeit.default_timer()
                    callback_list.on_batch_begin(batch_ind, {})
                    callback_list.on_forward_begin(batch_ind, (x, y))
                    size = self.size_fn(x, y)
                    with (torch.profiler.record_function("train_step") if prof is not None
                          else contextlib.nullcontext()):
                        logs = _steps.train_step(self.bundle, self.optimizer, x, y,
                                                 self.generator(epoch, batch_ind), flags=flags,
                                                 accumulator=self.accumulator)
                    sums.add(logs["loss"], [logs[m] for m in self.metrics_names], size)
                    callback_list.on_backward_end(batch_ind)
                    callback_list.on_batch_end(batch_ind, {
                        "batch": batch_ind, "size": size,
                        "time": timeit.default_timer() - batch_begin_time,
                        "batch_begin_time": batch_begin_time, **logs,
                    })
                    if preemption is not None and preemption.triggered and batch_ind < n_steps:
                        preempted_at = batch_ind
                        break
                    if (midtrain_path is not None and checkpoint_every_steps
                            and batch_ind % checkpoint_every_steps == 0 and batch_ind < n_steps):
                        self._save_midtrain(midtrain_path, epoch, batch_ind, sums, counter)
            finally:
                batches.close()  # stops and joins the prefetcher's thread
                if prof is not None:
                    stop_profile(prof, self.device,
                                 os.path.join(profile_dir, f"epoch_{epoch}.pt.trace.json.gz"))
            if preempted_at is None:
                if not sums.sizes and sums.base[2] == 0.0:
                    raise RuntimeError(f"epoch {epoch}: train generator yielded no batches "
                                       f"(expected {n_steps} steps); check the data pipeline")
                if preemption is not None and preemption.triggered:
                    preempted_at = n_steps  # the train phase is complete: resume runs the evals
            if preempted_at is not None:
                if midtrain_path is not None:
                    self._save_midtrain(midtrain_path, epoch, preempted_at, sums, counter)
                flush_pending_writes()
                self.preempted = True
                print(f"Preempted at epoch {epoch} batch {preempted_at}: mid-epoch state saved "
                      f"to {midtrain_path}; resume to continue from the next batch")
                return self.bundle.model

            loss_sum, metric_sums, size_sum = sums.totals()
            train_dict = {"loss": float(loss_sum / size_sum),
                          **{m: float(v) for m, v in zip(self.metrics_names,
                                                         metric_sums / size_sum)}}
            if math.isnan(train_dict["loss"]):
                stop_training = True
            if midtrain_path is not None:
                # the epoch's train phase is done, so its recovery point is stale; the
                # removal waits for any queued write of it
                enqueue_after_writes(
                    lambda p=midtrain_path: os.path.exists(p) and os.remove(p))

            val_dict = (self.eval_loop(valid_generator, "val", steps=validation_steps,
                                       auc=auc, ece=ece)
                        if valid_generator is not None else {})
            test_dict = (self.eval_loop(test_generator, "test", steps=test_steps,
                                        auc=auc, ece=ece)
                         if test_generator is not None else {})
            epoch_log = {
                "epoch": epoch,
                "time": timeit.default_timer() - epoch_begin_time,
                "epoch_begin_time": epoch_begin_time,
                **train_dict, **val_dict, **test_dict,
            }
            if self.plateau is not None:
                self.optimizer.lr_scale = self.plateau.step(epoch_log[scheduler_metric])
            callback_list.on_epoch_end(epoch, epoch_log)

            if epoch_log.get("acc") == 100:
                counter += 1
            if counter >= patience:
                stopped_epoch, stop_training = epoch, True
            if stop_training:
                break

        callback_list.on_train_end({})
        flush_pending_writes()  # the checkpoints are on disk when the loop returns
        if stopped_epoch > 0:
            print("Epoch %05d: completed stopping" % stopped_epoch)
        return self.bundle.model
