"""Streaming input pipeline for training: host featurize workers, the
length-bucketed batch schedule, a device stage one step ahead, and per-stage
accounting (counterpart of ``repro/data/pipeline.py``).

Stages, each accounted in :class:`StageReport`:

1. **schedule**: ``data.bucketing.BucketSchedule``, (seed, step) -> (bucket,
   record indices), deterministic and independent of the worker count.
2. **featurize**: ``make_batch(step)`` on a thread pool (``workers > 0``)
   with ordered reassembly: finished batches wait in a dict keyed by step
   and leave strictly in step order, so the stream is the same bits for 1
   worker or 16.  ``workers=0`` featurizes inline in ``__next__``.  Workers
   build numpy only and never touch CUDA.
3. **device**: with a CUDA ``device``, the consumer's thread copies each
   host batch into pinned CPU tensors and issues their host-to-device copy
   ``non_blocking`` on a dedicated copy stream, step t+1's before step t is
   yielded, so the copy overlaps step t's compute (the reference's
   ``jax.device_put`` one step ahead).  Before a batch is yielded the
   consumer's current stream waits on its copy's event and each device
   tensor is recorded on that stream, so nothing that stream runs reads a
   batch still in flight, and the allocator does not hand its memory out
   while the stream may still read it.  A pinned buffer is released only
   after its copy's event has completed.  With ``device=None`` or the CPU
   the stage does nothing and batches stay numpy.

Telemetry (``obs`` / ``tracer``, as the reference's): ``featurize`` spans
on the worker threads, a ``device_put`` span around each batch's placement
(issuing the pinned copy on the copy stream; on the CPU the stage places
nothing and its span only marks the hand-over), ``input_wait`` around the
consumer's wait for a batch, and the stage report mirrored into ``data/*``
gauges at each yield.

Worker exceptions never hang the consumer: a failure is carried to the
consumer and re-raised from ``__next__`` at its step, after the steps before
it have been yielded.

Lifecycle as ``data.loader.ShardedLoader``'s: one live iteration at a time,
``close()`` is idempotent, a new iteration restarts at ``start_step`` (to
resume a run, construct the pipeline with the resumed ``start_step``: the
schedule is a pure function of (seed, step), so the resumed stream equals
the fresh run's tail).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
import traceback
from collections import deque
from typing import Callable, Iterator, Optional, Union

import numpy as np

from repro_torch.data import bucketing as bk
from repro_torch.obs import trace_span


class WorkerFailure:
    """An exception captured on a worker thread, carried to the consumer.

    ``item`` is the work item that failed (for ``DataPipeline`` the step),
    so the consumer delivers the failure in stream order."""

    def __init__(self, exc: BaseException, item=None):
        self.exc = exc
        self.item = item
        self.tb = traceback.format_exc()

    def reraise(self):
        raise self.exc


class HostWorkerPool:
    """Bounded-in-flight thread pool: backlog -> workers -> ready queue.

    ``submit`` enqueues an item, workers apply ``fn``, ``poll`` drains the
    results.  ``cap`` bounds the work in flight: None (no bound), an int, or
    ``cap(head_item) -> int``, an item-aware bound (the serving featurize
    stage's per-bucket depth).  Exceptions come back as :class:`WorkerFailure`
    results (``poll(raise_failures=True)`` re-raises), so a failed item never
    strands the consumer on an empty queue.  ``workers=0`` applies ``fn``
    inline in ``submit``.  ``close`` waits for the item a worker is running
    and drops those not started.  ``stats``: items done, seconds in ``fn``
    and the most items ever in flight.
    """

    def __init__(self, fn: Callable, *, workers: int = 0,
                 cap: Union[None, int, Callable] = None,
                 name: str = "host-stage"):
        self.fn = fn
        self.workers = workers
        self.cap = cap
        self.stats = {"done": 0, "busy_s": 0.0, "max_inflight": 0}
        self._ready: "queue.Queue" = queue.Queue()
        self._backlog: deque = deque()
        self._inflight = 0
        self._lock = threading.Lock()
        self._pool = None
        if workers > 0:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=workers,
                                            thread_name_prefix=name)

    def _cap_for(self, item) -> int:
        if self.cap is None:
            return 1 << 30
        return self.cap(item) if callable(self.cap) else int(self.cap)

    def _run(self, item):
        t0 = time.perf_counter()
        try:
            out = self.fn(item)
        except BaseException as e:  # noqa: BLE001 — carried to the consumer
            out = WorkerFailure(e, item=item)
        dt = time.perf_counter() - t0
        with self._lock:
            self.stats["done"] += 1
            self.stats["busy_s"] += dt
        return out

    def _worker(self, item):
        try:
            self._ready.put(self._run(item))
        finally:
            with self._lock:
                self._inflight -= 1
            self._pump()

    def _pump(self):
        while True:
            with self._lock:
                if not self._backlog:
                    return
                if self._inflight >= self._cap_for(self._backlog[0]):
                    return
                head = self._backlog.popleft()
                self._inflight += 1
                self.stats["max_inflight"] = max(
                    self.stats["max_inflight"], self._inflight)
            try:
                self._pool.submit(self._worker, head)
            except RuntimeError:      # shut down: the item is dropped
                return

    def submit(self, item) -> None:
        if self._pool is None:
            self._ready.put(self._run(item))
            return
        with self._lock:
            self._backlog.append(item)
        self._pump()

    def poll(self, block: bool = False, timeout: Optional[float] = None,
             raise_failures: bool = False) -> list:
        """Drain finished results; ``block=True`` waits for at least one
        (returns [] only on timeout or an idle pool)."""
        out: list = []
        if block and self._ready.empty() and self.pending:
            try:
                out.append(self._ready.get(timeout=timeout or 30.0))
            except queue.Empty:
                return out
        while True:
            try:
                out.append(self._ready.get_nowait())
            except queue.Empty:
                break
        if raise_failures:
            for r in out:
                if isinstance(r, WorkerFailure):
                    r.reraise()
        return out

    @property
    def pending(self) -> int:
        with self._lock:
            return self._inflight + len(self._backlog)

    def close(self):
        if self._pool is not None:
            with self._lock:
                self._backlog.clear()
            self._pool.shutdown(wait=True, cancel_futures=True)


# ---------------------------------------------------------------------------
# Per-stage accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StageReport:
    """Cumulative per-stage seconds of one pipeline iteration.

    ``featurize_s`` is worker wall time spent building batches (overlapped
    with the consumer's steps when workers > 0, so accounted, not added);
    ``queue_s`` is how long finished host batches waited before pickup;
    ``transfer_s`` is the consumer's host time placing batches on the device
    (copies into pinned memory and issuing the asynchronous host-to-device
    copies); ``stall_s`` is what the consumer waited for input in
    ``__next__``, the number the training loop feels.
    """
    steps: int = 0
    batches: int = 0          # host batches accounted (>= steps: lookahead
                              # picks up step t+1's batch before t yields)
    featurize_s: float = 0.0
    queue_s: float = 0.0
    transfer_s: float = 0.0
    stall_s: float = 0.0
    wall_s: float = 0.0
    fill_sum: float = 0.0
    bucket_counts: dict = dataclasses.field(default_factory=dict)

    @property
    def stall_fraction(self) -> float:
        return self.stall_s / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def mean_fill(self) -> float:
        return self.fill_sum / self.batches if self.batches else 1.0

    def as_dict(self) -> dict:
        return {
            "steps": self.steps,
            "featurize_ms_per_step": round(
                1e3 * self.featurize_s / max(self.steps, 1), 3),
            "queue_ms_per_step": round(
                1e3 * self.queue_s / max(self.steps, 1), 3),
            "transfer_ms_per_step": round(
                1e3 * self.transfer_s / max(self.steps, 1), 3),
            "stall_ms_per_step": round(
                1e3 * self.stall_s / max(self.steps, 1), 3),
            "stall_fraction": round(self.stall_fraction, 4),
            "mean_fill": round(self.mean_fill, 4),
            "buckets": dict(self.bucket_counts),
        }

    def describe(self) -> str:
        d = self.as_dict()
        return (f"data: stall {d['stall_ms_per_step']}ms/step "
                f"({100 * d['stall_fraction']:.1f}% of loop), featurize "
                f"{d['featurize_ms_per_step']}ms, queue "
                f"{d['queue_ms_per_step']}ms, transfer "
                f"{d['transfer_ms_per_step']}ms, fill {d['mean_fill']:.2f}")


@dataclasses.dataclass
class _HostBatch:
    step: int
    batch: dict
    featurize_s: float
    fill: float
    bucket: Optional[bk.Bucket]
    ready_t: float            # perf_counter when the worker finished


@dataclasses.dataclass
class _Placed:
    """A batch whose host-to-device copy was issued on the copy stream:
    the device tensors, the copy's event and the pinned sources it reads."""
    batch: dict
    event: object
    pinned: dict


# keys a training batch carries: exactly ``data.protein.protein_sample``'s
# (the padding's row masks are left out: training runs the trunk unmasked,
# and the losses mask through res_mask)
TRAIN_BATCH_KEYS = ("msa_feat", "extra_msa_feat", "target_feat",
                    "residue_index", "res_mask", "true_msa",
                    "msa_mask_positions", "true_rots", "true_trans")


class DataPipeline:
    """Streaming (step, batch) iterator: schedule -> featurize -> device.

    ``source=None`` is the compat path: ``make_batch(step)`` is exactly
    ``data.protein.protein_batch(seed, step, batch_size, cfg)``, the stream
    ``TrainRunner`` has always trained on.  A ``data.ingest`` source switches
    to the record path: per-record ``featurize_record``, ``BucketSchedule``
    composition and ``pad_record_to_bucket``.

    ``pad_to`` puts every batch onto one bucket (training: one step shape,
    while bucketing still groups similar lengths per batch, which
    ``mean_fill`` shows).  Without it each batch takes its schedule
    bucket's shape.

    ``device``: a CUDA device turns the device stage on (see the module
    docstring); the yielded batches are then dicts of tensors on it.  None
    or the CPU yields the host batches (numpy).

    ``obs`` (a ``MetricRegistry``) and ``tracer`` (a ``SpanTracer``; None:
    the process's, if any) turn telemetry on (module docstring).
    """

    def __init__(self, cfg, *, source=None, batch_size: int = 1,
                 seed: int = 0, start_step: int = 0, workers: int = 1,
                 prefetch: int = 2, bucket_by_length: bool = False,
                 pad_to: Optional[bk.Bucket] = None, device=None,
                 make_batch: Optional[Callable] = None, obs=None,
                 tracer=None):
        self.cfg = cfg
        self.obs = obs
        self.tracer = tracer
        self.source = source
        self.batch_size = batch_size
        self.seed = seed
        self.start_step = start_step
        self.workers = workers
        self.prefetch = max(1, prefetch)
        self.bucket_by_length = bucket_by_length
        self.pad_to = pad_to
        self.device = _cuda_device(device)
        self.report = StageReport()
        self._custom_make_batch = make_batch
        self._copy_stream = None
        self.schedule = None
        if source is not None:
            buckets = (bk.length_bucket_table(cfg) if bucket_by_length
                       else [pad_to or bk.train_bucket(cfg)])
            lengths = [source.record_length(i) for i in range(len(source))]
            self.schedule = bk.BucketSchedule(
                lengths, buckets, seed=seed, batch_size=batch_size,
                bucket_by_length=bucket_by_length)
        elif bucket_by_length:
            raise ValueError(
                "bucket_by_length needs a record source (the synthetic "
                "compat stream is fixed-shape); pass source=SyntheticSource("
                "cfg, vary_length=True) or a FastaSource")
        self._pool: Optional[HostWorkerPool] = None
        self._gen = None
        self._token = None
        self._live = False
        self._lock = threading.Lock()

    # -- batch synthesis (pure in (seed, step)) ------------------------------

    def _make_batch(self, step: int) -> _HostBatch:
        with trace_span("featurize", tracer=self.tracer, step=step):
            return self._make_batch_inner(step)

    def _make_batch_inner(self, step: int) -> _HostBatch:
        t0 = time.perf_counter()
        if self._custom_make_batch is not None:
            batch, fill, bucket = self._custom_make_batch(step), 1.0, None
        elif self.source is None:
            from repro_torch.data.protein import protein_batch
            batch = protein_batch(self.seed, step, self.batch_size, self.cfg)
            fill, bucket = 1.0, None
        else:
            from repro_torch.data.ingest import featurize_record
            plan = self.schedule.batch_plan(step)
            bucket = self.pad_to or plan.bucket
            padded = []
            n_valid = 0
            for slot, rec_idx in enumerate(plan.indices):
                rec = self.source.record(rec_idx)
                feats = featurize_record(rec, self.cfg, seed=self.seed,
                                         step=step, idx=slot)
                n_valid += rec.n_res
                padded.append(bk.pad_record_to_bucket(feats, bucket))
            batch = bk.stack_batch(padded)
            batch = {k: batch[k] for k in TRAIN_BATCH_KEYS}
            fill = n_valid / (len(plan.indices) * bucket.n_res)
        dt = time.perf_counter() - t0
        return _HostBatch(step=step, batch=batch, featurize_s=dt, fill=fill,
                          bucket=bucket, ready_t=time.perf_counter())

    # -- device stage (the consumer's thread only) ---------------------------

    def _place(self, hb: _HostBatch):
        """Issue ``hb``'s host-to-device copy on the copy stream; returns a
        :class:`_Placed`, or the host batch when the stage is off."""
        with trace_span("device_put", tracer=self.tracer, step=hb.step):
            return self._place_inner(hb)

    def _place_inner(self, hb: _HostBatch):
        if self.device is None:
            return hb.batch
        import torch
        t0 = time.perf_counter()
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        stream = self._copy_stream
        pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for k, v in hb.batch.items()}
        with torch.cuda.stream(stream):
            placed = {k: t.to(self.device, non_blocking=True)
                      for k, t in pinned.items()}
            event = torch.cuda.Event()
            event.record(stream)
        self.report.transfer_s += time.perf_counter() - t0
        return _Placed(placed, event, pinned)

    def _deliver(self, placed):
        """The batch to yield: the consumer's stream waits on the copy."""
        if not isinstance(placed, _Placed):
            return placed
        import torch
        current = torch.cuda.current_stream(self.device)
        current.wait_event(placed.event)
        for t in placed.batch.values():
            t.record_stream(current)
        return placed.batch

    # -- iteration -----------------------------------------------------------

    def __iter__(self) -> Iterator:
        with self._lock:
            if self._live:
                raise RuntimeError(
                    "DataPipeline is already being iterated; close() it "
                    "before starting a second iteration (two consumers "
                    "would race one ordered stream)")
            self._live = True
        self.report = StageReport()
        pool = None
        if self.workers > 0:
            pool = HostWorkerPool(self._make_batch, workers=self.workers,
                                  cap=self.prefetch + self.workers,
                                  name="featurize")
        token = object()
        self._pool, self._token = pool, token
        gen = self._run(pool, token)
        self._gen = gen
        return gen

    def _run(self, pool, token) -> Iterator:
        try:
            yield from self._iterate(pool)
        finally:
            # tear down THIS iteration only: a generator finalized late
            # (GC) must not clobber a newer iteration's state
            if pool is not None:
                pool.close()
            with self._lock:
                if self._token is token:
                    self._live = False
                    self._gen = self._pool = self._token = None

    def _iterate(self, pool) -> Iterator:
        buffer: dict = {}
        next_submit = self.start_step
        if pool is not None:
            for _ in range(self.prefetch + self.workers):
                pool.submit(next_submit)
                next_submit += 1

        def drain(block: bool) -> None:
            # failures are keyed by their step and delivered in stream
            # order, not raised at poll time
            for r in pool.poll(block=block):
                key = r.item if isinstance(r, WorkerFailure) else r.step
                buffer[key] = r

        def host_batch(step: int, block: bool) -> Optional[_HostBatch]:
            nonlocal next_submit
            if pool is None:
                return self._make_batch(step) if block else None
            drain(block=False)
            while block and step not in buffer:
                drain(block=True)
            hb = buffer.pop(step, None)
            if hb is not None:
                pool.submit(next_submit)
                next_submit += 1
            return hb

        t_loop = time.perf_counter()
        pending: Optional[tuple] = None     # (step, placed) issued one ahead
        released = None                     # the last yielded _Placed
        step = self.start_step
        while True:
            t0 = time.perf_counter()
            if pending is not None and pending[0] == step:
                placed = pending[1]
                pending = None
            else:
                with trace_span("input_wait", tracer=self.tracer, step=step):
                    hb = host_batch(step, block=True)
                if isinstance(hb, WorkerFailure):
                    raise RuntimeError(
                        f"DataPipeline worker failed at step {step} "
                        f"(make_batch raised)") from hb.exc
                self._account(hb)
                placed = self._place(hb)
            self.report.stall_s += time.perf_counter() - t0
            # issue step+1's device copy BEFORE yielding step: the
            # asynchronous copy overlaps the consumer's compute
            if pool is not None and self.device is not None:
                nb = host_batch(step + 1, block=False)
                if isinstance(nb, WorkerFailure):
                    buffer[step + 1] = nb    # re-buffer: raised when reached
                elif nb is not None:
                    self._account(nb)
                    pending = (step + 1, self._place(nb))
            if isinstance(released, _Placed):
                # the previous batch's pinned sources go back to the host
                # allocator once their copy is done
                released.event.synchronize()
            released = placed
            out = self._deliver(placed)
            self.report.steps += 1
            self.report.wall_s = time.perf_counter() - t_loop
            if self.obs is not None:
                self._mirror_report()
            yield step, out
            step += 1

    def _mirror_report(self) -> None:
        """The stage report into ``data/*`` gauges; the consumer's registry
        tick writes them to the sinks, so the stall report shows mid-run."""
        r, obs = self.report, self.obs
        obs.gauge("data/stall_fraction").set(r.stall_fraction)
        obs.gauge("data/featurize_s").set(r.featurize_s)
        obs.gauge("data/queue_s").set(r.queue_s)
        obs.gauge("data/transfer_s").set(r.transfer_s)
        obs.gauge("data/stall_s").set(r.stall_s)
        obs.gauge("data/mean_fill").set(r.mean_fill)

    def _account(self, hb: _HostBatch) -> None:
        self.report.batches += 1
        self.report.featurize_s += hb.featurize_s
        self.report.queue_s += max(0.0, time.perf_counter() - hb.ready_t)
        self.report.fill_sum += hb.fill
        if hb.bucket is not None:
            key = hb.bucket.describe()
            self.report.bucket_counts[key] = (
                self.report.bucket_counts.get(key, 0) + 1)

    def close(self):
        """Stop the current iteration (idempotent); the pipeline returns to
        a fresh state, so ``iter -> close -> iter`` restarts at
        ``start_step``."""
        gen = self._gen
        if gen is not None:
            gen.close()     # raises GeneratorExit inside -> _run's finally
        with self._lock:
            if gen is not None and self._gen is gen:
                # the generator was never started: closing it cannot run
                # _run's finally, so release this iteration's state here
                if self._pool is not None:
                    self._pool.close()
                self._live = False
                self._gen = self._pool = self._token = None


def _cuda_device(device):
    """``device`` when it names a CUDA device, else None (no device stage)."""
    if device is None:
        return None
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
