"""Host-side span tracer with Chrome-trace / Perfetto JSON export, and a
``torch.profiler`` capture window (the port's copy of
``repro/obs/tracing.py``).

``with trace_span("step", step=7):`` records one complete event
("ph": "X") when it exits, with the thread's nesting depth, so that a
child's interval lying inside its parent's can be tested.  Timestamps come
from one ``perf_counter`` epoch per tracer, in microseconds, the unit
Chrome traces use.  Spans measure the host: a span around device work ends
after that work's synchronize or host copy, or it measures the enqueue.

The tracer is passed explicitly (``trace_span(name, tracer=t)``) or
installed for the process with :func:`set_tracer`, so that deep call sites
need no plumbing.  With neither, ``trace_span`` does nothing.

:class:`ProfileWindow` arms ``torch.profiler`` over a step interval
``A:B`` (``--profile-steps``), aligned to the step ids of the host spans.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional, Tuple


_PID = 1     # one process per trace: the Chrome-trace pid of every event


class SpanTracer:
    """Collects nestable host spans; exports Chrome-trace JSON."""

    def __init__(self, *, process_name: str = "repro"):
        self.process_name = process_name
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._local = threading.local()
        self.events: list = []          # finished spans, in completion order
        self._tids: dict = {}           # thread ident -> small int
        self._tid_names: dict = {}      # small int -> thread name

    def now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = len(self._tids)
                self._tids[ident] = tid
                self._tid_names[tid] = threading.current_thread().name
            return tid

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str, **args):
        tid = self._tid()
        stack = self._stack()
        depth = len(stack)
        t0 = self.now_us()
        stack.append(name)
        try:
            yield self
        finally:
            stack.pop()
            t1 = self.now_us()
            ev = {"name": name, "ph": "X", "ts": t0, "dur": t1 - t0,
                  "pid": _PID, "tid": tid,
                  "args": {k: _arg(v) for k, v in args.items()}}
            ev["args"]["depth"] = depth
            with self._lock:
                self.events.append(ev)

    def to_chrome_trace(self) -> dict:
        """Chrome-trace JSON object, loadable by Perfetto (ui.perfetto.dev)
        and chrome://tracing."""
        with self._lock:
            meta = [{"name": "process_name", "ph": "M", "pid": _PID,
                     "tid": 0, "args": {"name": self.process_name}}]
            for tid in sorted(self._tid_names):
                meta.append({"name": "thread_name", "ph": "M",
                             "pid": _PID, "tid": tid,
                             "args": {"name": self._tid_names[tid]}})
            return {"traceEvents": meta + list(self.events),
                    "displayTimeUnit": "ms"}

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def spans(self, name: Optional[str] = None) -> list:
        with self._lock:
            return [e for e in self.events
                    if name is None or e["name"] == name]


def _arg(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


# -- the process's tracer (worker threads reach it without plumbing) ----------

_GLOBAL: Optional[SpanTracer] = None


def set_tracer(tracer: Optional[SpanTracer]) -> Optional[SpanTracer]:
    """Install ``tracer`` for the process; returns the previous one."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = tracer
    return prev


def get_tracer() -> Optional[SpanTracer]:
    return _GLOBAL


@contextmanager
def trace_span(name: str, *, tracer: Optional[SpanTracer] = None, **args):
    """A span on ``tracer``, else on the process's tracer; nothing when
    neither is set."""
    t = tracer if tracer is not None else _GLOBAL
    if t is None:
        yield None
        return
    with t.span(name, **args):
        yield t


# -- torch.profiler capture window --------------------------------------------

def parse_profile_steps(spec: str) -> Tuple[int, int]:
    """``"A:B"`` -> (A, B): the capture starts entering step A and ends
    after step B-1 (half-open, as a Python slice)."""
    a, _, b = spec.partition(":")
    lo, hi = int(a), int(b)
    if hi <= lo:
        raise ValueError(f"--profile-steps {spec!r}: need A < B")
    return lo, hi


class ProfileWindow:
    """Arms ``torch.profiler.profile`` over the half-open step range
    ``[lo, hi)``: CPU activities, and CUDA activities (CUPTI) when
    ``device`` is a card.

    Call :meth:`maybe_start` / :meth:`maybe_stop` at each step boundary
    with the step id; the Chrome trace is exported into ``logdir`` as
    ``steps_<lo>-<hi>.pt.trace.json`` (``trace_path`` once written).  A
    failure to start or stop is logged and does not end the run.
    """

    def __init__(self, lo: int, hi: int, logdir: str, log=print,
                 device=None):
        self.lo, self.hi = lo, hi
        self.logdir = logdir
        self.log = log
        self.device = device
        self.active = False
        self.trace_path: Optional[str] = None
        self._prof = None

    def _activities(self):
        import torch
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self.device is not None and torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def maybe_start(self, step: int) -> None:
        if self.active or step != self.lo:
            return
        try:
            from torch.profiler import profile
            prof = profile(activities=self._activities())
            prof.start()
            self._prof, self.active = prof, True
            self.log(f"[obs] torch.profiler capture ON at step {step} "
                     f"-> {self.logdir}")
        except Exception as e:  # noqa: BLE001 — profiling must not end a run
            self.log(f"[obs] torch.profiler start failed: {e}")
            self.lo = -1  # no retry

    def maybe_stop(self, step: int) -> None:
        if not self.active or step + 1 != self.hi:
            return
        self.active = False
        try:
            self._prof.stop()
            os.makedirs(self.logdir, exist_ok=True)
            path = os.path.join(self.logdir,
                                f"steps_{self.lo}-{self.hi}.pt.trace.json")
            self._prof.export_chrome_trace(path)
            self.trace_path = path
            self.log(f"[obs] torch.profiler capture OFF after step {step} "
                     f"-> {path}")
        except Exception as e:  # noqa: BLE001 — profiling must not end a run
            self.log(f"[obs] torch.profiler stop failed: {e}")
        self._prof = None

    def close(self) -> None:
        if self.active:  # a run that ended inside the window
            self.active = False
            try:
                self._prof.stop()
            except Exception:  # noqa: BLE001 — nothing to report to
                pass
            self._prof = None
