"""Dynamic micro-batching, the serving runtime (port of ``serving.py``'s
``MicroBatcher``): concurrent single samples coalesced into batched predictor
calls, with admission control. Used by the predictors' micro-batchers
(``serving.py``) and the artifact micro-batchers (``export.py``); it imports
no model code.
"""
from __future__ import annotations

from typing import Optional, Sequence


class Overloaded(RuntimeError):
    """Raised by :meth:`MicroBatcher.submit` when the admission queue is
    full (``max_pending``); maps to HTTP 503 in the serving endpoint."""


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket holding ``n``; past the largest bucket, ``n`` rounded up
    to a multiple of it."""
    for b in buckets:
        if n <= b:
            return b
    return _round_up(n, buckets[-1])


class MicroBatcher:
    """Dynamic request batching in front of a predictor.

    Concurrent callers submit single samples; a collector thread coalesces
    them into one batched ``predict_batch`` call (up to ``max_batch`` samples,
    waiting at most ``max_wait_ms`` after the first arrival), then hands each
    caller's future its result.

    ``predict_batch``: ``list[sample] -> sequence[result]`` (one result per
    sample, same order). Exceptions fail every request in that batch.
    """

    _CLOSE = object()  # queue sentinel: no submit/close race, no idle polling

    def __init__(self, predict_batch, *, max_batch: int = 32,
                 max_wait_ms: float = 5.0, max_pending: Optional[int] = None):
        import queue as _queue
        import threading as _threading

        self.predict_batch = predict_batch
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        # backpressure: a bounded admission queue sheds load at the door
        # (Overloaded -> HTTP 503). None = unbounded.
        self.max_pending = max_pending
        self._q: "_queue.Queue" = _queue.Queue()
        self._pending = 0
        self._closed = _threading.Event()
        self._submit_lock = _threading.Lock()
        self._thread = _threading.Thread(target=self._collect, daemon=True)
        self._thread.start()

    def submit(self, sample):
        """Enqueue one sample; returns a concurrent.futures.Future. Raises
        :class:`Overloaded` when ``max_pending`` requests are already queued."""
        from concurrent.futures import Future

        fut: Future = Future()
        # atomic closed-check + enqueue: every accepted request lands BEFORE
        # close()'s sentinel, so none is orphaned
        with self._submit_lock:
            if self._closed.is_set():
                raise RuntimeError("MicroBatcher is closed")
            if (self.max_pending is not None
                    and self._pending >= self.max_pending):
                raise Overloaded(
                    f"{self._pending} requests pending (max_pending="
                    f"{self.max_pending})"
                )
            self._pending += 1
            self._q.put((sample, fut))
        return fut

    def __call__(self, sample):
        return self.submit(sample).result()

    def close(self):
        """Stop the collector; requests accepted before close are still served
        (the sentinel travels the queue behind them)."""
        with self._submit_lock:
            already = self._closed.is_set()
            self._closed.set()
            if not already:
                self._q.put(self._CLOSE)
        self._thread.join()

    # -- collector ---------------------------------------------------------
    def _drain_remaining(self):
        """Serve requests that landed behind the sentinel, then exit."""
        import queue as _queue

        while True:
            batch = []
            while len(batch) < self.max_batch:
                try:
                    item = self._q.get_nowait()
                except _queue.Empty:
                    break
                if item is not self._CLOSE:
                    batch.append(item)
            if not batch:
                return
            self._serve(batch)

    def _serve(self, batch):
        # these items left the admission queue: free their pending slots
        with self._submit_lock:
            self._pending -= len(batch)
        # claim the futures: cancelled ones drop out, live ones can no longer
        # be cancelled mid-flight
        samples, futures = [], []
        for s, f in batch:
            if f.set_running_or_notify_cancel():
                samples.append(s)
                futures.append(f)
        if not samples:
            return
        try:
            results = self.predict_batch(samples)
            if len(results) != len(samples):
                raise ValueError(
                    f"predict_batch returned {len(results)} results "
                    f"for {len(samples)} samples"
                )
        except BaseException as e:  # handed to every caller's future
            for f in futures:
                f.set_exception(e)
        else:
            for f, r in zip(futures, results):
                f.set_result(r)

    def _collect(self):
        import queue as _queue
        import time as _time

        while True:
            first = self._q.get()
            if first is self._CLOSE:
                self._drain_remaining()
                return
            batch = [first]
            deadline = _time.monotonic() + self.max_wait_s
            saw_close = False
            while len(batch) < self.max_batch:
                timeout = deadline - _time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = self._q.get(timeout=timeout)
                except _queue.Empty:
                    break
                if item is self._CLOSE:
                    saw_close = True
                    break
                batch.append(item)
            self._serve(batch)
            if saw_close:
                self._drain_remaining()
                return
