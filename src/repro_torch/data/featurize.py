"""Host-side featurize stage of fold serving (counterpart of
``repro/data/featurize.py``).

It turns a ``FoldRequest``'s raw features into a bucket-padded,
digest-stamped :class:`Featurized` item, inline or on host threads, so the
device stage (``serve/scheduler.py``) does not wait on input preparation.

* ``feature_digest``: a sha256 over the request's feature arrays (sorted
  keys; each array's key, shape, dtype and bytes), the same hex string as
  the reference's.  The result cache keys on it: folding draws no random
  numbers, so two requests with one digest fold to the same result.
* ``FeaturizePipeline``: inline at ``workers=0`` (deterministic) or on a
  ``data.pipeline.HostWorkerPool`` of threads, its in-flight bound the
  prefetch depth of the head item's bucket, deeper for smaller buckets.
  A worker's exception is re-raised from ``poll``.

Workers run numpy only and never touch CUDA.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional

import numpy as np

from repro_torch.data.pipeline import HostWorkerPool
from repro_torch.serve import fold_steps as fs

# featurize prefetch depth: DEPTH_BASE items in flight for the largest
# bucket, more for smaller ones, within [DEPTH_MIN, DEPTH_MAX]
DEPTH_BASE, DEPTH_MIN, DEPTH_MAX = 4, 2, 16


def feature_digest(features: dict) -> str:
    """Content hash of a request's (unpadded) feature arrays: invariant to
    dict order and host layout, sensitive to any key, shape, dtype or
    value."""
    h = hashlib.sha256()
    for k in sorted(features):
        a = np.ascontiguousarray(np.asarray(features[k]))
        h.update(k.encode())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class Featurized:
    """One request after the featurize stage, and its stage ledger:
    ``featurize_s`` is host wall seconds of padding and hashing (overlapped
    with the device stage when workers > 0, so accounted, not added);
    ``ready_s`` / ``admit_s`` / ``finish_s`` are virtual-clock instants the
    scheduler fills in."""
    request: object               # FoldRequest
    bucket: fs.Bucket
    padded: dict                  # bucket-padded features + validity masks
    digest: str
    featurize_s: float
    ready_s: float = 0.0          # left this stage
    admit_s: float = 0.0          # entered a batch slot
    finish_s: float = 0.0         # its fold completed


class FeaturizePipeline:
    """The featurize stage feeding the admission scheduler.  ``workers=0``
    featurizes inline in ``submit``; ``workers > 0`` on a thread pool whose
    in-flight bound is :meth:`depth_for` of the head request's bucket;
    ``poll`` drains what finished."""

    def __init__(self, buckets, *, workers: int = 0):
        self.buckets = sorted(buckets)
        self.workers = workers
        self._pool = HostWorkerPool(
            self._featurize, workers=workers, name="featurize",
            cap=lambda req: self.depth_for(
                fs.bucket_for(self.buckets, req.features)))

    def depth_for(self, bucket: fs.Bucket) -> int:
        """Prefetch depth of a bucket: inversely proportional to its residue
        pad, ``DEPTH_BASE`` for the largest bucket, clamped to
        [``DEPTH_MIN``, ``DEPTH_MAX``]."""
        largest = self.buckets[-1].n_res
        d = round(DEPTH_BASE * largest / max(bucket.n_res, 1))
        return max(DEPTH_MIN, min(DEPTH_MAX, d))

    def _featurize(self, request) -> Featurized:
        t0 = time.perf_counter()
        bucket = fs.bucket_for(self.buckets, request.features)
        padded = fs.pad_to_bucket(request.features, bucket)
        digest = feature_digest(request.features)
        return Featurized(request=request, bucket=bucket, padded=padded,
                          digest=digest,
                          featurize_s=time.perf_counter() - t0)

    @property
    def stats(self) -> dict:
        ps = self._pool.stats
        return {"featurized": ps["done"], "featurize_s": ps["busy_s"],
                "max_inflight": ps["max_inflight"]}

    def submit(self, request) -> None:
        self._pool.submit(request)

    def poll(self, block: bool = False,
             timeout: Optional[float] = None) -> list:
        """Drain finished items; ``block=True`` waits for at least one
        (returns [] only on timeout or an idle stage).  A worker's
        exception is re-raised here, on the caller's thread."""
        return self._pool.poll(block=block, timeout=timeout,
                               raise_failures=True)

    @property
    def pending(self) -> int:
        return self._pool.pending

    def close(self) -> None:
        self._pool.close()
