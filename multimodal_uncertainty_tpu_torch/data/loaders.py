"""Host-side batch loaders (port of ``data/loaders.py:34-259``).

``ArrayLoader`` slices whole in-memory arrays (FashionMNIST's views) into
batches; ``MapLoader`` turns a map-style dataset into collated numpy batches,
with an optional thread pool and a background prefetch thread. ``len()`` is the
number of batches (ceil), torch ``DataLoader(drop_last=False)`` semantics.
``prefetch_to_device`` moves the next batches to the device from a
background thread, through pinned host buffers and a side CUDA stream.

The epoch permutation is a stateless function of ``(seed, epoch)``
(``np.random.default_rng([seed, epoch])``), the JAX package's: the two
packages see identical batches, and a resumed run replays the data order of
an uninterrupted one.
"""
from __future__ import annotations

import contextlib
import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

import numpy as np
import torch

from multimodal_uncertainty_tpu_torch.device import resolve_device


def _epoch_perm(seed: int, epoch: int, n: int, shuffle: bool) -> np.ndarray:
    """Index order for one epoch, derived statelessly from (seed, epoch)."""
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng([seed, epoch]).shuffle(idx)
    return idx


class ArrayLoader:
    """Whole-dataset arrays -> ``(x, y)`` numpy batches (``(x0, x1, ..., y)``
    for more than two arrays), the last batch short; ``sample_size`` keeps
    the first rows. The JAX package's ``ArrayLoader``: the same batches in
    the same order for a seed and epoch."""

    def __init__(self, arrays, batch_size: int, *, shuffle: bool = False, seed: int = 0,
                 sample_size: Optional[int] = None):
        n = len(arrays[0])
        if any(len(a) != n for a in arrays[1:]):
            raise ValueError(f"arrays differ in length: {[len(a) for a in arrays]}")
        if sample_size is not None:
            arrays = [a[:sample_size] for a in arrays]
        self.arrays = [np.asarray(a) for a in arrays]
        self.n = len(self.arrays[0])
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._auto_epoch = 0

    def __len__(self):
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        epoch, self._auto_epoch = self._auto_epoch, self._auto_epoch + 1
        return self.iter_epoch(epoch)

    def iter_epoch(self, epoch: int, start_batch: int = 0):
        """Iterate epoch ``epoch`` deterministically from batch ``start_batch``."""
        idx = _epoch_perm(self.seed, epoch, self.n, self.shuffle)
        for start in range(start_batch * self.batch_size, self.n, self.batch_size):
            sel = idx[start:start + self.batch_size]
            batch = tuple(a[sel] for a in self.arrays)
            yield batch if len(batch) > 2 else (batch[0], batch[1])


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


def map_batch(batch, fn):
    """``fn`` over every array of a loader's ``(x, y)`` batch, ``x`` a tuple
    of arrays, (ViLT) a dict of them or (FashionMNIST) one array."""
    x, y = batch
    if isinstance(x, dict):
        return {k: fn(a) for k, a in x.items()}, fn(y)
    if isinstance(x, (tuple, list)):
        return tuple(fn(a) for a in x), fn(y)
    return fn(x), fn(y)


def flat_batch(batch) -> list:
    """The arrays (or tensors) of an ``(x, y)`` batch, ``x``'s first."""
    x, y = batch
    if isinstance(x, dict):
        return [*x.values(), y]
    return [*x, y] if isinstance(x, (tuple, list)) else [x, y]


PREFETCH_DEPTH = 2  # batches in flight ahead of the consumer, the JAX package's depth


class _PinnedSlot:
    """Pinned host buffers for one batch in flight, reused once the event
    behind that batch's copies has completed."""

    def __init__(self):
        self.buffers: list = []
        self.done: Optional[torch.cuda.Event] = None

    def stage(self, index: int, a) -> torch.Tensor:
        """Copy the array ``a`` into this slot's ``index``-th pinned buffer
        (grown to fit) and return the pinned tensor of its shape and dtype."""
        src = torch.from_numpy(np.ascontiguousarray(a))
        nbytes = src.numel() * src.element_size()
        if index == len(self.buffers):
            self.buffers.append(None)
        buf = self.buffers[index]
        if buf is None or buf.numel() < nbytes:
            buf = self.buffers[index] = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                                    pin_memory=True)
        pinned = buf[:nbytes].view(src.dtype).view(src.shape)
        pinned.copy_(src)
        return pinned


def prefetch_to_device(batches, device):
    """The loader's ``(x, y)`` batches as tensors on ``device``, copied
    ahead of the consumer from a background thread (the JAX package's
    ``DevicePrefetcher``; torch ``DataLoader``'s ``pin_memory`` with
    ``non_blocking`` copies). The trainer moves large batches this way
    (``training/trainer.py::move_batches``).

    On CUDA the thread (``_produce_in_thread``) copies each array into a
    pinned host buffer and starts its copy to the card with
    ``non_blocking=True`` on a side stream, recording an event behind the
    copies; up to ``PREFETCH_DEPTH`` batches are in flight. The consumer
    makes its current stream wait on that event and calls ``record_stream``
    on each tensor it hands out, so the caching allocator does not reuse
    their memory before the step that reads them has run. A pinned buffer is
    rewritten only after the event of its last copy has completed. ``None``
    is ``cuda``, which raises without a card; on ``cpu`` (only when the
    caller asks for it) the thread yields the arrays as tensors, with no
    pinning and no stream. ``x`` is a tuple of arrays or, for ViLT, a dict
    of them."""
    device = resolve_device(device)
    if device.type == "cpu":
        yield from _produce_in_thread(
            (lambda b=b: map_batch(b, lambda a: torch.as_tensor(np.asarray(a))) for b in batches),
            PREFETCH_DEPTH)
        return
    stream = torch.cuda.Stream(device)
    slots = [_PinnedSlot() for _ in range(PREFETCH_DEPTH + 1)]
    turn = itertools.count()

    def put(batch):
        slot = slots[next(turn) % len(slots)]
        if slot.done is not None:
            slot.done.synchronize()  # its last copies have read the buffers
        index = itertools.count()
        with torch.cuda.device(device), torch.cuda.stream(stream):
            out = map_batch(batch, lambda a: slot.stage(next(index), a).to(
                device, non_blocking=True))
            slot.done = torch.cuda.Event()
            slot.done.record(stream)
        return out, slot.done

    # closed with this generator (a consumer that stops early, a preempted epoch): the thread
    # is cancelled and joined then, not when the collector gets to it
    with contextlib.closing(_produce_in_thread((lambda b=b: put(b) for b in batches),
                                               PREFETCH_DEPTH)) as produced:
        for out, done in produced:
            current = torch.cuda.current_stream(device)
            current.wait_event(done)
            for t in flat_batch(out):
                t.record_stream(current)
            yield out


def subset_then_loaders(training, dev, testing, collate_fn, args) -> tuple:
    """Train (shuffled, truncated to ``args.sample_size``), dev and test loaders."""
    workers = getattr(args, "n_workers", 0)
    train_loader = MapLoader(training, args.batch_size, collate_fn, shuffle=True,
                             seed=args.seed, num_workers=workers, sample_size=args.sample_size)
    dev_loader = MapLoader(dev, args.batch_size, collate_fn, num_workers=workers)
    test_loader = MapLoader(testing, args.batch_size, collate_fn, num_workers=workers)
    return train_loader, dev_loader, test_loader
