"""The op trace: the port's counterpart of a jaxpr, which every analysis
pass walks.

:func:`tracing` runs code under a ``TorchDispatchMode`` that keeps one
:class:`OpRecord` per aten op of the forward and the backward: its name, the
shapes and dtypes of its inputs and outputs, its phase (``bwd`` while the
autograd engine runs a node, else ``fwd``) and a path, the chain of the
port's function frames that issued it (``loss_fn/forward/.../pair_branch``:
the counterpart of the jaxpr path ``shard_map/scan/pjit``).  Only shapes
are kept, never tensors.

Three kinds of node are recorded by the port's own code while a trace is
active (``repro_torch.trace_hooks.ACTIVE``, one module-level check when
none is):

* **kernel nodes** (``kernels.ops``): one node per kernel entry point or
  autograd ``forward`` / ``backward``, named after its kernel
  (``evo_attention_fwd``, ``triangle_mult_bwd_dx``, ...), with the kernel's
  output shapes; the aten ops of the plain version inside are not
  recorded.  The counterpart of a ``pallas_call`` eqn;
* **collective nodes** (``parallel.collectives``): kind, axis name, bytes,
  and for the overlapped DAP prefetch an id that links an
  ``all_gather`` start to its wait;
* **dropout sites** (``core.evoformer.shared_dropout``): the key's source
  and path, and the site (the frames that called it, with their lines).
"""
from __future__ import annotations

import collections
import contextlib
import math
import sys
from typing import Iterable, Iterator, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import trace_hooks

# the contractions (the counterpart of dot_general)
CONTRACTIONS = frozenset({"mm", "bmm", "addmm", "baddbmm"})
# views that einsum puts after its contraction (the plain K1 logits
# ``einsum("lshc,lthc->lhst")`` are a bmm of (l*h, s, t), then a view)
_EINSUM_VIEWS = frozenset({"view", "_unsafe_view", "reshape", "permute",
                           "transpose", "unsqueeze", "squeeze", "expand",
                           "alias", "as_strided", "t"})
# aten ops whose input shapes the passes read (precision)
_READ_INPUTS = CONTRACTIONS | {"rsqrt", "sqrt"}

_PORT_DIR = "/repro_torch/"
_TORCH_FUNCTIONAL = ("torch/functional.py", "torch\\functional.py")


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def op_elems(shape) -> int:
    return int(math.prod(shape)) if shape else 1


class OpRecord(NamedTuple):
    name: str                 # aten op, kernel, collective kind, "dropout"
    kind: str                 # aten | comm | kernel | collective | dropout
    phase: str                # fwd | bwd
    path: str
    in_shapes: tuple = ()     # ((shape, dtype), ...)
    out_shapes: tuple = ()
    contraction: bool = False  # a contraction's output, or einsum's view of it
    attrs: dict = {}


_DTYPE_NAMES: dict = {}


def _shapes(tensors) -> tuple:
    out = []
    for t in tensors:
        dt = _DTYPE_NAMES.get(t.dtype)
        if dt is None:
            dt = _DTYPE_NAMES[t.dtype] = dtype_name(t.dtype)
        out.append((tuple(t.shape), dt))
    return tuple(out)


_Tensor = torch.Tensor


def _tensors(tree, out=None) -> list:
    """The tensors of nested tuples, lists and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, _Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            if isinstance(x, _Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple, dict)):
                _tensors(x, out)
    elif isinstance(tree, dict):
        _tensors(tuple(tree.values()), out)
    return out


class OpTrace:
    """The records of one traced call, in host issue order.  ``inputs``:
    the traced function's inputs, ``(index, kind, dtype, shape)`` with kind
    ``tensor`` or the Python type of a plain number; ``kernel_nodes``:
    whether kernel entry points were recorded as nodes (False: their plain
    versions' aten ops were)."""

    def __init__(self, *, kernel_nodes: bool = True):
        self.records: list = []
        self.inputs: list = []
        self.kernel_nodes = kernel_nodes
        self.paused = 0
        self._contracted = WeakIdKeyDictionary()
        self._key_ids = WeakIdKeyDictionary()
        self._code_is_port: dict = {}
        self._next_pair = 0
        self._base = None        # the frame the trace started in
        self._last = (None, -1, None)   # (frame, instruction, path)

    def __len__(self) -> int:
        return len(self.records)

    def forward_prefix(self) -> "OpTrace":
        """The records before the first backward one: the forward of the
        first loss (the ``fwd`` role of a train program)."""
        out = OpTrace(kernel_nodes=self.kernel_nodes)
        out.inputs = list(self.inputs)
        for r in self.records:
            if r.phase == "bwd":
                break
            out.records.append(r)
        return out

    # -- recording ---------------------------------------------------------

    def _frames(self, frame) -> list:
        """The port's function names from ``frame`` out to the trace's
        start."""
        out = []
        base = self._base
        while frame is not None and frame is not base:
            code = frame.f_code
            port = self._code_is_port.get(code)
            if port is None:
                port = _PORT_DIR in code.co_filename.replace("\\", "/")
                self._code_is_port[code] = port
            if port:
                out.append(code.co_name)
            frame = frame.f_back
        return out[::-1]

    def site(self, frame) -> str:
        """Every frame from ``frame`` out to the trace's start, as
        ``function:line``: one call site of the traced code."""
        out = []
        while frame is not None and frame is not self._base:
            out.append(f"{frame.f_code.co_name}:{frame.f_lineno}")
            frame = frame.f_back
        return "/".join(out[::-1])

    def _where(self, frame) -> tuple:
        """(phase, path) of an op issued from ``frame``.  Consecutive ops of
        one Python call (a matmul's view, mm, view) share its frame and
        instruction, so its path is walked once."""
        node = torch._C._current_autograd_node()
        if frame is None or frame is not self._last[0] or \
                frame.f_lasti != self._last[1]:
            names = self._frames(frame)
            self._last = (frame, getattr(frame, "f_lasti", -1),
                          "/".join(names) if names else None)
        path = self._last[2]
        if path is None:
            path = f"backward/{node.name()}" if node is not None else ""
        return ("bwd" if node is not None else "fwd"), path

    def _record_aten(self, func, args, kwargs, out, frame) -> None:
        name = func.overloadpacket.__name__
        kind = "comm" if func.namespace == "c10d" else "aten"
        ins = _tensors(args)
        if kwargs:
            _tensors(kwargs, ins)
        outs = _tensors(out)
        contraction = name in CONTRACTIONS or (
            name in _EINSUM_VIEWS and ins and ins[0] in self._contracted
            and frame is not None and frame.f_code.co_name == "einsum"
            and frame.f_code.co_filename.endswith(_TORCH_FUNCTIONAL))
        if contraction:
            for t in outs:
                self._contracted[t] = True
        # input shapes only where a pass reads them
        self.records.append(OpRecord(
            name, kind, *self._where(frame),
            _shapes(ins) if name in _READ_INPUTS else (), _shapes(outs),
            contraction))

    def record(self, kind: str, name: str, ins=(), outs=(), frame=None,
               **attrs) -> OpRecord:
        rec = OpRecord(name, kind, *self._where(frame),
                       _shapes(_tensors(ins)), _shapes(_tensors(outs)),
                       attrs=attrs)
        self.records.append(rec)
        return rec

    def key_source(self, rng) -> str:
        """A stable name for a dropout key's source: ``lanes#n`` for the
        n-th distinct lanes tensor of this trace, ``words(...)`` for a
        tuple of host words."""
        lanes = getattr(rng, "lanes", None)
        if lanes is None:
            return f"words{tuple(rng)}"
        if lanes not in self._key_ids:
            self._key_ids[lanes] = f"lanes#{len(self._key_ids)}"
        return self._key_ids[lanes]

    def new_pair(self) -> int:
        self._next_pair += 1
        return self._next_pair


class _Recorder(TorchDispatchMode):
    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # nothing under a trace is compiled: keep __torch_dispatch__ a plain
        # method (no dynamo-disable wrapper, no import of torch._dynamo)
        return False

    def __init__(self, trace: OpTrace):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.trace.paused:
            self.trace._record_aten(func, args, kwargs, out,
                                     trace_hooks.caller(1))
        return out


@contextlib.contextmanager
def tracing(*, kernel_nodes: bool = True, ops: bool = True):
    """Record every op run inside the block into the yielded
    :class:`OpTrace` (one trace at a time, per process).  ``ops=False``
    records the port's own nodes only (kernels, collectives, dropout
    sites), not the aten ops, at a fraction of the cost."""
    if trace_hooks.ACTIVE is not None:
        raise RuntimeError("an op trace is already being recorded")
    trace = OpTrace(kernel_nodes=kernel_nodes)
    trace._base = sys._getframe(2)     # the with statement's frame
    trace_hooks.ACTIVE = trace
    try:
        with _Recorder(trace) if ops else contextlib.nullcontext():
            yield trace
    finally:
        trace_hooks.ACTIVE = None
        trace._last = trace._base = None    # drop the frames (and locals)


def _input_kinds(args, static: Iterable[int]) -> list:
    out = []
    static = set(static)
    for i, a in enumerate(args):
        if i in static:
            continue
        if isinstance(a, torch.Tensor):
            out.append((i, "tensor", dtype_name(a.dtype), tuple(a.shape)))
        elif isinstance(a, (bool, int, float)):
            out.append((i, type(a).__name__, type(a).__name__, ()))
        else:
            out.append((i, "other", type(a).__name__, ()))
    return out


def capture(fn, *args, static: Iterable[int] = (), kernel_nodes: bool = True,
            ops: bool = True, **kwargs) -> Tuple[OpTrace, object]:
    """``(trace, fn(*args, **kwargs))``.  The positional ``args`` not listed
    in ``static`` are the traced step's inputs (``trace.inputs``), which the
    retrace pass holds to be tensors.  ``kernel_nodes`` / ``ops``: as
    :func:`tracing`."""
    with tracing(kernel_nodes=kernel_nodes, ops=ops) as trace:
        trace.inputs = _input_kinds(args, static)
        out = fn(*args, **kwargs)
    return trace, out


# ---------------------------------------------------------------------------
# Walkers (the API of the reference's jaxpr_walk)
# ---------------------------------------------------------------------------

def iter_ops(trace: OpTrace, kinds=("aten", "kernel")) -> Iterator[OpRecord]:
    """The records of the given kinds, in issue order."""
    kinds = set(kinds)
    for r in trace.records:
        if r.kind in kinds:
            yield r


def iter_out_shapes(trace: OpTrace) -> Iterator[Tuple[tuple, str, OpRecord]]:
    """``(shape, dtype, record)`` for every output of an aten op or a
    kernel node."""
    for r in iter_ops(trace):
        for shape, dtype in r.out_shapes:
            yield shape, dtype, r


def peak_op_elems(trace: OpTrace) -> int:
    """The largest op output, in elements (the proxy for peak intermediate
    memory that the materialization guarantees use)."""
    return max((op_elems(s) for s, _, _ in iter_out_shapes(trace)), default=0)


def count_ops(trace: OpTrace, names: Iterable[str]) -> dict:
    """Occurrences of each op or kernel-node name."""
    names = set(names)
    counts = collections.Counter({n: 0 for n in names})
    for r in iter_ops(trace):
        if r.name in names:
            counts[r.name] += 1
    return dict(counts)


def collective_axis_counts(trace: OpTrace) -> collections.Counter:
    """``Counter[(kind, axis)]`` of the collectives issued (an async gather
    counts once, at its start)."""
    counts: collections.Counter = collections.Counter()
    for r in iter_ops(trace, ("collective",)):
        if r.attrs.get("event") != "wait":
            counts[(r.name, r.attrs["axis"])] += 1
    return counts
