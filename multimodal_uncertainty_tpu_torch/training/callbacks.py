"""Keras-style callbacks (port of ``training/callbacks.py``).

Same event surface: ``on_{train,epoch,batch}_{begin,end}``,
``on_forward_begin``, ``on_backward_end``, ``on_val_batch_end``. The trainer
fires them on the host; per-batch logs carry device scalars, which the
progress lines read only every ``sync_every`` batches.
"""
from __future__ import annotations

import itertools
import logging
import sys
import timeit

import numpy as np

from multimodal_uncertainty_tpu_torch.training.checkpoint import save_weights

logger = logging.getLogger(__name__)


class CallbackList:
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def append(self, callback):
        self.callbacks.append(callback)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_trainer(self, trainer):
        for c in self.callbacks:
            c.set_trainer(trainer)

    def __iter__(self):
        return iter(self.callbacks)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def dispatch(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)

            return dispatch
        raise AttributeError(name)


class Callback:
    trainer = None
    params = None
    save_path = None

    def set_params(self, params):
        self.params = params

    def set_trainer(self, trainer):
        self.trainer = trainer

    def set_save_path(self, save_path):
        self.save_path = save_path

    def on_epoch_begin(self, epoch, logs):
        pass

    def on_epoch_end(self, epoch, logs):
        pass

    def on_batch_begin(self, batch, logs):
        pass

    def on_batch_end(self, batch, logs):
        pass

    def on_forward_begin(self, batch, data):
        pass

    def on_backward_end(self, batch):
        pass

    def on_train_begin(self, logs):
        pass

    def on_train_end(self, logs):
        pass

    def on_val_batch_end(self, batch, logs):
        pass


class LambdaCallback(Callback):
    def __init__(self, on_epoch_begin=None, on_epoch_end=None, on_batch_begin=None,
                 on_batch_end=None, on_train_begin=None, on_train_end=None):
        super().__init__()
        for name, fn in (("on_epoch_begin", on_epoch_begin), ("on_epoch_end", on_epoch_end),
                         ("on_batch_begin", on_batch_begin), ("on_batch_end", on_batch_end),
                         ("on_train_begin", on_train_begin), ("on_train_end", on_train_end)):
            if fn:
                setattr(self, name, fn)


class ModelCheckpoint(Callback):
    """Best-metric checkpointing. Mode inference ("acc"/"fmeasure" -> max)
    and the verbose messages are the reference's. Reads the model and
    optimizer state from the trainer at save time."""

    def __init__(self, filepath, monitor="val_loss", verbose=0, save_best_only=False,
                 mode="auto", period=1):
        super().__init__()
        self.monitor = monitor
        self.verbose = verbose
        self.filepath = filepath
        self.save_best_only = save_best_only
        self.period = period
        self.epochs_since_last_save = 0
        if mode not in ("auto", "min", "max"):
            mode = "auto"
        if mode == "min":
            self.monitor_op, self.best = np.less, np.inf
        elif mode == "max":
            self.monitor_op, self.best = np.greater, -np.inf
        elif "acc" in self.monitor or self.monitor.startswith("fmeasure"):
            self.monitor_op, self.best = np.greater, -np.inf
        else:
            self.monitor_op, self.best = np.less, np.inf

    def _save(self):
        model_state, opt_state = self.trainer.checkpointable_state()
        save_weights(model_state, opt_state, self.filepath)

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        self.epochs_since_last_save += 1
        if self.epochs_since_last_save < self.period:
            return
        self.epochs_since_last_save = 0
        if not self.save_best_only:
            if self.verbose > 0:
                print("Epoch %05d: saving model to %s" % (epoch, self.filepath))
            self._save()
            return
        current = logs.get(self.monitor)
        if current is None:
            logger.warning("Can save best model only with %s available, skipping.", self.monitor)
            return
        current = float(current)
        if self.monitor_op(current, self.best):
            if self.verbose > 0:
                print("Epoch %05d: %s improved from %0.5f to %0.5f, saving model to %s"
                      % (epoch, self.monitor, self.best, current, self.filepath))
            self.best = current
            self._save()
        elif self.verbose > 0:
            print("Epoch %05d: %s did not improve" % (epoch, self.monitor))


class ProgressionCallback(Callback):
    """Per-batch and per-epoch progress lines. The per-batch logs carry device
    scalars; the line re-reads them (one device sync) every ``sync_every``
    batches, and the epoch-end line shows exact values."""

    sync_every = 25

    def on_train_begin(self, logs):
        self.metrics = ["loss"] + list(self.trainer.metrics_names)
        self.epochs = self.params["epochs"]
        self.steps = self.params["steps"]

    def on_epoch_begin(self, epoch, logs):
        self.step_times_sum = 0.0
        self.epoch = epoch
        self._cached_metrics_str = ""
        sys.stdout.write("\rEpoch %d/%d" % (self.epoch, self.epochs))
        sys.stdout.flush()

    def on_epoch_end(self, epoch, logs):
        print("\rEpoch %d/%d %.2fs: %s"
              % (self.epoch, self.epochs, logs.get("time", 0.0), self._metrics_string(logs)))

    def on_batch_end(self, batch, logs):
        self.step_times_sum += timeit.default_timer() - logs["batch_begin_time"]
        if batch % self.sync_every == 1 or batch == self.steps:
            self._cached_metrics_str = self._metrics_string(logs)
        times_mean = self.step_times_sum / max(batch, 1)
        if self.steps is not None:
            sys.stdout.write("\rEpoch %d/%d ETA %.2fs Step %d/%d: %s"
                             % (self.epoch, self.epochs, times_mean * (self.steps - batch),
                                batch, self.steps, self._cached_metrics_str))
        else:
            sys.stdout.write("\rEpoch %d/%d %.2fs/step Step %d: %s"
                             % (self.epoch, self.epochs, times_mean, batch,
                                self._cached_metrics_str))
        sys.stdout.flush()

    def _metrics_string(self, logs):
        train = ("{}: {:f}".format(k, float(logs[k])) for k in self.metrics
                 if logs.get(k) is not None)
        val = ("{}: {:f}".format("val_" + k, float(logs["val_" + k])) for k in self.metrics
               if logs.get("val_" + k) is not None)
        return ", ".join(itertools.chain(train, val))


class ValidationProgressionCallback(Callback):
    sync_every = 25  # see ProgressionCallback

    def __init__(self, phase, metrics_names, steps=None):
        super().__init__()
        self.phase = phase
        self.steps = steps
        self.metrics = metrics_names
        self._cached_metrics_str = ""

    def on_batch_begin(self, batch, logs):
        if batch == 1:
            self.step_times_sum = 0.0
            self._cached_metrics_str = ""

    def on_batch_end(self, batch, logs):
        self.step_times_sum += timeit.default_timer() - logs["batch_begin_time"]
        if batch % self.sync_every == 1 or batch == self.steps:
            self._cached_metrics_str = ", ".join(
                "{}_{}: {:f}".format(self.phase, k, float(logs[k]))
                for k in self.metrics if logs.get(k) is not None
            )
        times_mean = self.step_times_sum / max(batch, 1)
        if self.steps is not None:
            sys.stdout.write("\r%s ETA %.2fs Step %d/%d: %s."
                             % (self.phase, times_mean * (self.steps - batch), batch,
                                self.steps, self._cached_metrics_str))
        else:
            sys.stdout.write("\r%s %.2fs/step Step %d: %s."
                             % (self.phase, times_mean, batch, self._cached_metrics_str))
        sys.stdout.flush()
