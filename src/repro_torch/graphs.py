"""Captured steps: the port's counterpart of the reference's ``jax.jit``
caches (``repro/serve/fold_engine.py::step_for``, ``repro/serve/engine.py``'s
``_decode`` / ``_prefill1``).

PyTorch runs eagerly, one Python call per kernel launch; on the card the
host then bounds every serving step.  A :class:`CapturedStep` records a
function of tensors once as a CUDA graph and replays it: one launch from
the host per call.

* The first call runs the function eagerly on a side stream (the warm-up
  PyTorch asks for before a capture: library handles, kernel attributes,
  constants cached per device), and its result is that call's result.  Then
  the function is captured on the same static inputs; a capture records
  work and runs none of it.  The garbage collector is run before the
  capture and held off during it: a dead graph freed inside another's
  capture (a graph left in a reference cycle is freed whenever the
  collector runs) calls ``cudaGraphExecDestroy``, which a capture does not
  permit, and that invalidates the capture.
* Every later call copies its arguments into the static input buffers,
  replays the graph and returns the static outputs.  They are overwritten
  by the next replay of any graph of the same memory pool: read or clone
  them before that.
* The kernel wrappers count launches in Python (``kernels/ops.py``).  The
  counts a capture adds are taken back out, since nothing ran, and each
  replay credits them again, so the counters still count the launches
  that ran.

A capture that fails raises; nothing falls back to the eager function.
"""
from __future__ import annotations

import gc
from typing import Callable, Optional

import torch

from repro_torch.kernels import ops


def use_graphs(graphs: Optional[bool], device: torch.device,
               collectives: Optional[str] = None) -> bool:
    """An engine's ``graphs=`` keyword resolved on its device: None means on
    for CUDA and off for the CPU; True on a device without CUDA graphs
    raises ValueError.  ``collectives``: the backend of the process groups
    the step talks over (None: it talks to no other rank).  A CUDA graph
    cannot capture a gloo collective, so under gloo on a card None means off
    and True raises ValueError."""
    if collectives == "gloo" and device.type == "cuda":
        if graphs:
            raise ValueError(
                "CUDA graphs cannot capture gloo collectives (ranks that "
                "share a card talk over gloo); pass graphs=False")
        return False
    if graphs is None:
        return device.type == "cuda"
    if graphs and device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, got {device}; "
                         "pass graphs=False (or None) on the CPU")
    return bool(graphs)


def _require_cuda(args) -> None:
    for a in args:
        if not (isinstance(a, torch.Tensor) and a.is_cuda):
            raise ValueError("a CapturedStep takes CUDA tensors only, got "
                             f"{type(a).__name__} on "
                             f"{getattr(a, 'device', 'the host')}")


class CapturedStep:
    """``fn(*tensors) -> tensors`` as one CUDA graph, captured at the first
    call into ``pool`` (``torch.cuda.graph_pool_handle()``, shared by the
    graphs of one engine: they replay one at a time) and replayed after.
    Every call must pass tensors of the first call's shapes and dtypes.

    ``launches`` is what one replay credits to the kernel launch
    counters."""

    def __init__(self, fn: Callable, *, pool=None):
        self.fn, self.pool = fn, pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: list = []
        self.outputs = None
        self.launches: dict = {}

    def __call__(self, *args):
        if self.graph is None:
            return self._capture(args)
        if len(args) != len(self.inputs):
            raise ValueError(f"{len(args)} arguments, captured with "
                             f"{len(self.inputs)}")
        for buf, a in zip(self.inputs, args):
            if a.shape != buf.shape or a.dtype != buf.dtype:
                raise ValueError(f"argument {tuple(a.shape)} {a.dtype}, "
                                 f"captured with {tuple(buf.shape)} "
                                 f"{buf.dtype}")
            if a is not buf:
                buf.copy_(a)
        self.graph.replay()
        ops.add_launch_counts(self.launches)
        return self.outputs

    def _capture(self, args):
        _require_cuda(args)
        self.inputs = [a.clone() for a in args]
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream(device=main.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            result = self.fn(*self.inputs)
        main.wait_stream(side)
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                self.outputs = self.fn(*self.inputs)
        finally:
            if collecting:
                gc.enable()
        after = ops.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        ops.add_launch_counts({k: -n for k, n in self.launches.items()})
        self.graph = graph
        return result
