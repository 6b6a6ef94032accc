"""SIGTERM-safe training: mid-epoch checkpoints (port of ``training/preemption.py``).

Batch schedulers announce a preemption with SIGTERM and a short grace period.
The reference saves only at epoch ends, and its resumed DataLoader shuffles
anew. Here:

* :class:`PreemptionGuard` latches the signal (its handler only sets an
  event: no I/O, no CUDA call) and the trainer polls it between batches;
* at the first batch boundary after the signal the trainer writes
  ``model_midtrain.pt``: the whole train state (weights and BatchNorm
  statistics, the optimizer's moments and steps, the accumulated gradients,
  the plateau scheduler) and a ``mid`` blob with the epoch, the next batch
  and the epoch's running sums, then returns;
* ``--resume`` reloads it (``training/loop.py::resume_midtrain_state``) and
  re-enters that epoch at that batch through the loaders' stateless
  ``iter_epoch(epoch, start_batch)``. Every step's randomness is a function
  of (seed, epoch, batch), so the resumed run equals an uninterrupted one.

``--checkpoint_every_steps N`` writes the same file every N batches, a
recovery point for a crash that sends no signal.
"""
from __future__ import annotations

import signal
import threading
from typing import Iterable


class PreemptionGuard:
    """Latches termination signals so that training stops at a batch boundary.

    ``install`` must run on the main thread (CPython's rule for
    ``signal.signal``); ``request`` triggers the guard as the signal would,
    for a caller that learns of a preemption some other way."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._prev: dict = {}

    def install(self, signals: Iterable[int] = (signal.SIGTERM,)) -> "PreemptionGuard":
        for sig in signals:
            self._prev[sig] = signal.signal(sig, self._handler)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def _handler(self, signum, frame) -> None:
        self._event.set()  # nothing else: the handler runs between any two bytecodes

    def request(self) -> None:
        """Trigger as if the signal had arrived."""
        self._event.set()

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def clear(self) -> None:
        self._event.clear()
