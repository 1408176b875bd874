"""Metric registry: counters, gauges, histograms and named time series (the
port's copy of ``repro/obs/registry.py``).

The registry is the one funnel between subsystems and sinks.  Two ways of
recording:

* ``record(name, value, step=...)``: an **event**, appended to the name's
  series and written to every sink at once.  This is the per-step stream
  (``train/loss``, ``train/attribution``, ``serve/call``); :meth:`series`
  hands out the live list, so attributes such as ``TrainRunner.history``
  are views of the registry's contents, not copies.
* ``counter`` / ``gauge`` / ``histogram``: **instruments**, cheap updates in
  memory on the hot path, written to the sinks only at :meth:`tick` (once a
  step) and only when their payload changed since they were last written.

Values are Python numbers: a caller reads a tensor to the host
(``float(t)``) before recording it.

Determinism: two equal recording sequences give the same sink rows but for
the one wall-clock field ``t``; rows come in call order (a monotone
``seq``), the sinks sort JSON keys, tags are sorted tuples.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple


def jsonable(v):
    """Coerce numpy scalars and arrays and tuples into plain JSON types."""
    import numpy as np
    if isinstance(v, dict):
        return {str(k): jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [jsonable(x) for x in v]
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return [jsonable(x) for x in v.tolist()]
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


class Counter:
    """Monotone counter; ``inc`` is the only mutation."""

    kind = "counter"

    def __init__(self, name: str, tags: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.tags = tags
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def payload(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Last-value metric; ``set`` replaces."""

    kind = "gauge"

    def __init__(self, name: str, tags: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.tags = tags
        self.value: Optional[float] = None

    def set(self, v) -> None:
        self.value = float(v)

    def payload(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Streaming count / sum / min / max, and quantiles over the last
    ``window`` observations (a ring), linearly interpolated over the sorted
    window: p50 / p99 of step times and latencies without memory that grows
    with the run."""

    kind = "histogram"

    def __init__(self, name: str, tags: Tuple[Tuple[str, str], ...],
                 window: int = 1024):
        self.name = name
        self.tags = tags
        self.window = window
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._ring: List[float] = []
        self._head = 0

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if len(self._ring) < self.window:
            self._ring.append(v)
        else:
            self._ring[self._head] = v
            self._head = (self._head + 1) % self.window

    def quantile(self, q: float) -> Optional[float]:
        if not self._ring:
            return None
        xs = sorted(self._ring)
        pos = q * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

    def payload(self) -> dict:
        return {"count": self.count, "sum": round(self.sum, 9),
                "min": self.min, "max": self.max,
                "p50": self.quantile(0.50), "p99": self.quantile(0.99)}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricRegistry:
    """Tagged metric store and event series, fanning out to sinks.

    Thread-safe (featurize workers and the checkpoint writer record while
    the main thread steps); sinks are called under the lock, so their rows
    come in recording order.
    """

    def __init__(self, *, sinks=None):
        self._lock = threading.RLock()
        self.sinks = list(sinks or [])
        self._metrics: Dict[tuple, object] = {}
        self._series: Dict[str, list] = {}
        self._emitted: Dict[tuple, dict] = {}   # last payload tick wrote
        self._seq = 0

    # -- wiring --------------------------------------------------------------

    def add_sink(self, sink) -> None:
        with self._lock:
            self.sinks.append(sink)

    def _emit(self, row: dict) -> None:
        # callers hold the lock
        row["seq"] = self._seq
        self._seq += 1
        row["t"] = time.time()
        for s in self.sinks:
            s.write(row)

    # -- instruments ---------------------------------------------------------

    def _instrument(self, kind: str, name: str, tags: dict, **kw):
        # identity is (name, tags), not kind: registering "x" as a counter
        # and later as a gauge raises instead of interleaving two streams
        key = (name, tuple(sorted((k, str(v)) for k, v in tags.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = _KINDS[kind](name, key[1], **kw)
                self._metrics[key] = m
            elif m.kind != kind:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{m.kind}, not {kind}")
            return m

    def counter(self, name: str, **tags) -> Counter:
        return self._instrument("counter", name, tags)

    def gauge(self, name: str, **tags) -> Gauge:
        return self._instrument("gauge", name, tags)

    def histogram(self, name: str, window: int = 1024, **tags) -> Histogram:
        return self._instrument("histogram", name, tags, window=window)

    # -- events and series ---------------------------------------------------

    def series(self, name: str) -> list:
        """The live list behind ``name``'s event series: the registry
        appends to this same object, so a view handed out here (as
        ``TrainRunner.history``) is the registry's contents by identity."""
        with self._lock:
            return self._series.setdefault(name, [])

    def record(self, name: str, value, *, step: Optional[int] = None,
               **tags) -> None:
        """Append ``value`` to the series and write one row at once."""
        with self._lock:
            self._series.setdefault(name, []).append(value)
            self._emit({"kind": "event", "name": name,
                        "value": jsonable(value), "step": step,
                        "tags": jsonable(tags)})

    # -- per-step flush ------------------------------------------------------

    def tick(self, step: Optional[int] = None) -> None:
        """Step boundary: write every instrument whose payload changed since
        it was last written, then a ``tick`` row that sinks key their
        cadence on (the console summary prints there)."""
        with self._lock:
            for key in sorted(self._metrics):
                m = self._metrics[key]
                payload = m.payload()
                if self._emitted.get(key) == payload:
                    continue
                self._emitted[key] = payload
                self._emit({"kind": m.kind, "name": m.name,
                            "tags": dict(m.tags), "step": step,
                            **jsonable(payload)})
            self._emit({"kind": "tick", "name": "tick", "step": step})

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        """Deterministic {name[|tags]: payload} of every instrument, and the
        length of every series (``series:<name>``)."""
        with self._lock:
            out = {}
            for key in sorted(self._metrics):
                m = self._metrics[key]
                tag_s = ",".join(f"{k}={v}" for k, v in m.tags)
                out[f"{m.name}|{tag_s}" if tag_s else m.name] = m.payload()
            for name in sorted(self._series):
                out[f"series:{name}"] = len(self._series[name])
            return out

    def flush(self) -> None:
        with self._lock:
            for s in self.sinks:
                s.flush()

    def close(self) -> None:
        with self._lock:
            for s in self.sinks:
                s.close()
