"""Checkpoint I/O (port of ``training/checkpoint.py``).

Same artifact contract as the JAX package and its reference: files named
``model_best_val.pt``, ``model_epoch_{e}.pt``, ``model_last_epoch.pt`` (and
``model_midtrain.pt``, ``training/preemption.py``) holding ``{'model': ...,
'optimizer': ...}``, here as torch files of a state dict, read back with
``weights_only=True``. For training, ``'optimizer'`` holds the JAX package's
layout: ``{'opt_state': {'step', 'mu', 'nu', 'lr_scale'}, 'step': ...}``; the
learning-rate schedule is a function of the step and ``lr_scale``, so this is
the scheduler's state as well.

Writes are asynchronous by default, as the JAX package's: ``save_weights``
copies every tensor into host memory of its own before it returns (the next
optimizer step updates the parameters in place, so a queued write never holds
a view of a live tensor), and one writer thread serialises and writes the
files in the order they were queued, each atomically (a ``.tmp`` then a
rename). ``flush_pending_writes`` waits for the queue; it runs at exit too.
"""
from __future__ import annotations

import atexit
import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

logger = logging.getLogger(__name__)

# one FIFO writer: the copies to the host happen on the caller's thread, the
# serialisation and the disk writes on this one
_writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint-writer")
_pending_lock = threading.Lock()
_pending: dict = {}  # filename -> the Future of its last queued write


def _snapshot(tree):
    """Every tensor of ``tree`` copied into CPU memory of its own."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    return tree


def _write(state: dict, filename: str) -> None:
    tmp = filename + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, filename)


def flush_pending_writes() -> None:
    """Block until every queued write (and every task queued after them by
    ``enqueue_after_writes``) has run."""
    with _pending_lock:
        futures = list(_pending.values())
    for f in futures:
        f.result()
    try:
        _writer.submit(lambda: None).result()
    except RuntimeError:  # the executor is shut down (interpreter exit)
        pass


atexit.register(flush_pending_writes)


def save_weights(model: nn.Module | dict, opt_state: Optional[dict], filename: str, *,
                 async_write: bool = True) -> None:
    """Write ``{'model': state_dict, 'optimizer': opt_state or {}}`` atomically.
    The host copy is taken before this returns; the file is written on the
    writer thread (``async_write=False``: here, now)."""
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    state = {"model": _snapshot(dict(sd)),
             "optimizer": _snapshot(opt_state) if opt_state is not None else {}}
    if not async_write:
        _write(state, filename)
        return
    with _pending_lock:
        prev = _pending.get(filename)
    if prev is not None:
        prev.result()  # one write of a file in flight: the host copies queued stay bounded
    with _pending_lock:
        _pending[filename] = _writer.submit(_write, state, filename)


def enqueue_after_writes(fn: Callable[[], Any]) -> None:
    """Run ``fn()`` on the writer thread, after every write queued so far (the
    retention pruning, the removal of a finished epoch's ``model_midtrain.pt``).
    A failure is logged."""

    def guarded():
        try:
            fn()
        except Exception:
            logger.warning("checkpoint writer task %r failed", fn, exc_info=True)

    _writer.submit(guarded)


def load_weights(filename: str) -> Tuple[dict, Any]:
    """Returns (model_state_dict, opt_state), tensors on the CPU, after any
    queued write of ``filename``."""
    with _pending_lock:
        fut = _pending.get(filename)
    if fut is not None:
        fut.result()
    state = torch.load(filename, map_location="cpu", weights_only=True)
    return state["model"], state.get("optimizer", {})


def restore_into(model: nn.Module, loaded: dict) -> nn.Module:
    """Load ``loaded`` into ``model`` strictly: the same keys and shapes, cast
    to the model's dtypes. Raises ValueError on any mismatch."""
    own = model.state_dict()
    missing = sorted(set(own) - set(loaded))
    extra = sorted(set(loaded) - set(own))
    if missing or extra:
        raise ValueError(f"checkpoint keys differ: missing {missing}, unexpected {extra}")
    for k, t in own.items():
        if tuple(loaded[k].shape) != tuple(t.shape):
            raise ValueError(
                f"shape mismatch at {k}: checkpoint {tuple(loaded[k].shape)} "
                f"vs model {tuple(t.shape)}"
            )
    model.load_state_dict({k: loaded[k].to(own[k].dtype) for k in own}, strict=True)
    return model
