"""Hooks through which the port's kernels, collectives and dropout sites
report to an op trace.

:data:`ACTIVE` is the trace being recorded, or None;
``analysis.static.op_walk.tracing`` installs one.  The kernel entry points
(``kernels.ops``), the collectives (``parallel.collectives``) and
``core.evoformer.shared_dropout`` check it once per call and, while a trace
records, report one node through :func:`kernel_node`,
:func:`record_collective` or :func:`record_dropout`.  This module imports
nothing of the port, so those layers know nothing of the analysis passes.
"""
from __future__ import annotations

import sys
from typing import Optional

# the trace being recorded (an ``op_walk.OpTrace``), or None
ACTIVE = None


def caller(depth: int):
    """The frame ``depth`` levels above the caller of this function, or
    None where the stack is not that deep (an autograd engine thread runs
    a backward node with no Python frame under it)."""
    frame = sys._getframe(1)
    for _ in range(depth):
        if frame is None:
            return None
        frame = frame.f_back
    return frame


def kernel_node(name: str, fn, *args, **kwargs):
    """Run ``fn`` (a kernel or its plain version) with the trace paused and
    record it as one node named ``name`` with its outputs' shapes."""
    trace = ACTIVE
    trace.paused += 1
    try:
        out = fn(*args, **kwargs)
    finally:
        trace.paused -= 1
    trace.record("kernel", name, (args, kwargs), out, caller(1))
    return out


def record_collective(kind: str, axis: str, nbytes: int, *,
                      event: str = "sync", pair: Optional[int] = None
                      ) -> int:
    """A collective over mesh axis ``axis``: ``event`` ``sync``, or
    ``start`` / ``wait`` of an async gather (linked by ``pair``; a start
    gets a new id, which it returns)."""
    trace = ACTIVE
    if event == "start":
        pair = trace.new_pair()
    trace.record("collective", kind, frame=caller(2), axis=axis,
                 bytes=int(nbytes), event=event, pair=pair)
    return pair


def record_dropout(rng) -> None:
    """A dropout site drawing from ``rng`` (a ``Key`` or a tuple of
    words)."""
    trace = ACTIVE
    frame = caller(2)
    path = tuple(getattr(rng, "path", ()))
    trace.record("dropout", "dropout", frame=frame,
                 key=trace.key_source(rng), key_path=path,
                 site=trace.site(frame))
