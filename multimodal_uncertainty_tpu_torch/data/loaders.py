"""Host-side batch loaders (port of ``data/loaders.py:34-141,239-259``, numpy only).

``MapLoader`` turns a map-style dataset into collated numpy batches, with an
optional thread pool and a background prefetch thread. ``len()`` is the
number of batches (ceil), torch ``DataLoader(drop_last=False)`` semantics.

The epoch permutation is a stateless function of ``(seed, epoch)``
(``np.random.default_rng([seed, epoch])``), the JAX package's: the two
packages see identical batches, and a resumed run replays the data order of
an uninterrupted one.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

import numpy as np


def _epoch_perm(seed: int, epoch: int, n: int, shuffle: bool) -> np.ndarray:
    """Index order for one epoch, derived statelessly from (seed, epoch)."""
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng([seed, epoch]).shuffle(idx)
    return idx


class MapLoader:
    """Map-style dataset -> collated numpy batches, with threaded fetch and a
    background prefetch of ``prefetch`` batches."""

    def __init__(
        self,
        dataset: Any,  # supports __len__ / __getitem__
        batch_size: int,
        collate_fn: Callable,
        *,
        shuffle: bool = False,
        seed: int = 0,
        num_workers: int = 0,
        sample_size: Optional[int] = None,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.n = len(dataset) if sample_size is None else min(sample_size, len(dataset))
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self._auto_epoch = 0
        self._pool = ThreadPoolExecutor(max_workers=num_workers) if num_workers > 0 else None

    def __len__(self):
        return (self.n + self.batch_size - 1) // self.batch_size

    def _make_batch(self, sel):
        if self._pool is not None:
            items = list(self._pool.map(self.dataset.__getitem__, sel))
        else:
            items = [self.dataset[i] for i in sel]
        return self.collate_fn(items)

    def __iter__(self):
        epoch, self._auto_epoch = self._auto_epoch, self._auto_epoch + 1
        return self.iter_epoch(epoch)

    def iter_epoch(self, epoch: int, start_batch: int = 0):
        """Iterate epoch ``epoch`` deterministically, skipping the first
        ``start_batch`` batches without fetching them."""
        idx = _epoch_perm(self.seed, epoch, self.n, self.shuffle)
        batches = [idx[s:s + self.batch_size] for s in range(0, self.n, self.batch_size)]
        batches = batches[start_batch:]
        if self.prefetch <= 0:
            for sel in batches:
                yield self._make_batch(sel)
            return
        yield from _produce_in_thread(
            (lambda sel=sel: self._make_batch(sel) for sel in batches), self.prefetch)


def _produce_in_thread(thunks, maxsize: int):
    """Run ``thunks`` on a background thread, yielding their results through a
    bounded queue. Exceptions reach the consumer; a consumer that stops early
    cancels and joins the producer."""
    q: queue.Queue = queue.Queue(maxsize=maxsize)
    stop = object()
    cancel = threading.Event()

    def _put(item) -> bool:
        while True:
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                if cancel.is_set():
                    return False

    def producer():
        try:
            for thunk in thunks:
                if cancel.is_set() or not _put(thunk()):
                    return
            _put(stop)
        except BaseException as e:  # handed to the consumer
            _put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                t.join()
                raise item
            yield item
    finally:
        cancel.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:  # pragma: no cover
                break
        t.join()


def subset_then_loaders(training, dev, testing, collate_fn, args) -> tuple:
    """Train (shuffled, truncated to ``args.sample_size``), dev and test loaders."""
    workers = getattr(args, "n_workers", 0)
    train_loader = MapLoader(training, args.batch_size, collate_fn, shuffle=True,
                             seed=args.seed, num_workers=workers, sample_size=args.sample_size)
    dev_loader = MapLoader(dev, args.batch_size, collate_fn, num_workers=workers)
    test_loader = MapLoader(testing, args.batch_size, collate_fn, num_workers=workers)
    return train_loader, dev_loader, test_loader
