"""Prefetching loader: ``make_batch(step)`` on a worker thread, one batch
ahead of the consumer (counterpart of ``repro/data/loader.py``).

Batches are deterministic in (seed, step), so the loader only overlaps
their synthesis with the consumer's step.  A ``make_batch`` exception on the
worker is carried to the consumer and re-raised from the iterator: a dying
worker never leaves ``q.get()`` blocked.

Lifecycle: one iteration at a time.  ``__iter__`` while an iteration is live
raises; ``close()`` is idempotent and returns the loader to a fresh state,
so ``iter -> close -> iter`` works, each iteration restarting at
``start_step`` (resume a run by constructing the loader with the resumed
step).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


class _WorkerFailure:
    """Exception captured on the worker thread, re-raised by the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class ShardedLoader:
    def __init__(self, make_batch: Callable[[int], dict], *,
                 start_step: int = 0, prefetch: int = 2):
        self._make_batch = make_batch
        self._start_step = start_step
        self._prefetch = prefetch
        self._q: Optional[queue.Queue] = None
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    def _worker(self, q: queue.Queue, stop: threading.Event, step: int):
        while not stop.is_set():
            try:
                batch = self._make_batch(step)
            except BaseException as e:  # noqa: BLE001 — re-raised by consumer
                # a worker exception must reach the consuming iterator: a
                # dying thread would otherwise leave q.get() blocked forever
                # (the silent-hang failure mode this guards against)
                batch = _WorkerFailure(e)
            while not stop.is_set():
                try:
                    q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, _WorkerFailure):
                return      # the stream is over; consumer re-raises
            step += 1

    def __iter__(self) -> Iterator:
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(
                "ShardedLoader is already being iterated; close() it before "
                "starting a second iteration (two workers racing on one "
                "queue would interleave steps nondeterministically)")
        q = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()
        thread = threading.Thread(target=self._worker,
                                  args=(q, stop, self._start_step),
                                  daemon=True)
        self._q, self._stop, self._thread = q, stop, thread
        thread.start()
        try:
            while True:
                step, batch = q.get()
                if isinstance(batch, _WorkerFailure):
                    raise RuntimeError(
                        f"ShardedLoader worker failed at step {step} "
                        f"(make_batch raised)") from batch.exc
                yield step, batch
        finally:
            # close THIS iteration's resources only: a generator finalized
            # late (GC) must not tear down a newer iteration
            self._close(q, stop, thread)

    def close(self):
        """Stop the current iteration's worker; safe to call repeatedly."""
        if self._thread is not None:
            self._close(self._q, self._stop, self._thread)

    def _close(self, q, stop, thread):
        if stop is None:
            return
        stop.set()
        # drain so the worker unblocks from a full queue
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=2.0)
        if self._thread is thread:
            self._q = self._stop = self._thread = None
