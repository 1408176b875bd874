"""The dry run's analysis of one traced step: operations, bytes,
collectives and memory of one rank, counted while the step runs (the
counterpart of ``repro/launch/dryrun.py::analyse``, which reads XLA's
``cost_analysis`` / ``memory_analysis`` and the compiled HLO).

:func:`counting` runs code under a ``TorchDispatchMode`` and installs a
:class:`CostTrace` as the op trace that the port's kernels and collectives
report to (``trace_hooks``).  It keeps totals, not records, so a step of a
million ops costs a few seconds:

* ``per_device_flops``: ``torch.utils.flop_counter``'s formulas for the aten
  ops, plus each kernel node's operations (``kernels/cost.py``); a kernel's
  plain version or meta route inside its node is not counted;
* ``per_device_bytes``: input plus output bytes of every aten op that is not
  a view or a bare allocation, and each kernel node's bytes, before any
  fusion: the eager port's traffic;
* ``collectives``: ``{kind: {count, bytes}}`` under XLA's names (output
  bytes, as ``repro/analysis/hlo.py`` counts them), and the same per mesh
  axis, which the reference cannot give;
* ``memory``: every storage an op makes is live from then until it is freed
  (a weak reference to the storage sees that), counted once however many
  views it has; ``peak_bytes_estimate`` is the high-water mark of the live
  bytes, arguments included, and ``peak_storages`` the largest storages
  live near it.

The counter of live storages is this module's own (~60 lines) rather than
``torch.distributed._tools.mem_tracker.MemTracker``: that module is
private, attributes memory by module and optimizer phase (which the step
does not need), and its API has changed between torch releases.

It works on any device: the dry run counts on ``meta`` tensors, and the
tests count the same step on CPU tensors to hold the two to each other.
"""
from __future__ import annotations

import collections
import contextlib
import weakref
from typing import Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import trace_hooks
from repro_torch.kernels import cost as kcost

# the port's collective kinds -> XLA's names (repro/analysis/hlo.py)
XLA_KINDS = {"psum": "all-reduce", "pmax": "all-reduce",
             "all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
             "all_to_all": "all-to-all"}
# ops that only allocate: they read and write nothing
_ALLOCATIONS = ("empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided")
_Tensor = torch.Tensor


def _tensors(tree, out):
    if isinstance(tree, _Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    return id(t.untyped_storage())


# ---------------------------------------------------------------------------
# Kernel nodes: operations and bytes from the call's arguments
# ---------------------------------------------------------------------------

def _evo_fwd(q, k, v, bias, gate, scale=None, *, return_lse=False):
    L, S, H, C = q.shape
    return kcost.evo_attention_fwd_cost(
        L, S, H, C, q.element_size(),
        bias_el=bias.element_size() if bias is not None else 0,
        gated=gate is not None, lse=return_lse)


def _evo_bwd(q, k, v, bias, gate, out, lse, do, scale=None):
    L, S, H, C = q.shape
    return kcost.evo_attention_bwd_cost(
        L, S, H, C, q.element_size(),
        bias_el=bias.element_size() if bias is not None else 0,
        gated=gate is not None)


def _tri_fwd(xa, xb, xg, w_a, *rest, k_mask=None, return_s=False):
    r_i, r_k, c_z = xa.shape
    r_j = xb.shape[0]
    # the pair rows of each distinct activation read (xa, xb and xg may
    # view one tensor)
    seen, rows = set(), 0
    for t, n in ((xa, r_i * r_k), (xb, r_j * r_k), (xg, r_i * r_j)):
        key = _storage_key(t)
        if key not in seen:
            seen.add(key)
            rows += n
    return kcost.triangle_mult_fwd_cost(
        r_i, r_j, r_k, c_z, w_a.shape[1] // 2, xa.element_size(),
        act_rows=rows, s=return_s, masked=k_mask is not None)


def _tri_epi(s, xg, *rest):
    r_i, r_j, c = s.shape
    return kcost.triangle_mult_bwd_epilogue_cost(r_i * r_j, xg.shape[-1], c,
                                                 xg.element_size())


def _tri_dx(ds, x_loc, *rest):
    r_p, r_q, c = ds.shape
    return kcost.triangle_mult_bwd_dx_cost(r_p, r_q, x_loc.shape[1],
                                           x_loc.shape[2], c,
                                           x_loc.element_size())


def _flash(q, k, v, causal=True, scale=None):
    B, S, H, D = q.shape
    return kcost.flash_attention_fwd_cost(B, S, k.shape[1], H, k.shape[2], D,
                                          q.element_size(), causal=causal)


KERNEL_COSTS = {"evo_attention_fwd": _evo_fwd, "evo_attention_bwd": _evo_bwd,
                "triangle_mult_fwd": _tri_fwd,
                "triangle_mult_bwd_epilogue": _tri_epi,
                "triangle_mult_bwd_dx": _tri_dx,
                "flash_attention_fwd": _flash}


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------

class CostTrace:
    """Totals of one counted call; installed as ``trace_hooks.ACTIVE``
    (the interface of ``op_walk.OpTrace`` that the kernels, collectives and
    dropout sites call)."""

    kernel_nodes = True

    def __init__(self):
        self.paused = 0
        self.ops: collections.Counter = collections.Counter()
        self.op_bytes: collections.Counter = collections.Counter()
        self.kernels: collections.Counter = collections.Counter()
        self.aten_flops = 0.0
        self.kernel_flops = 0.0
        self.aten_bytes = 0.0
        self.kernel_bytes = 0.0
        self.collectives: dict = {}
        self.per_axis: dict = {}
        self.argument_bytes = 0
        self.live = 0
        self.peak = 0
        self.peak_storages: list = []
        self._live: dict = {}          # storage id -> (bytes, label)
        self._refs: dict = {}          # storage id -> weakref
        self._snap = 0                 # the live bytes of the last snapshot
        self._pairs = 0

    # -- memory ----------------------------------------------------------

    def hold(self, tensors: Iterable[torch.Tensor], label: str = "") -> int:
        """Count each tensor's storage as live (once); returns the bytes
        added."""
        added = 0
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = (n, label or f"{tuple(t.shape)} {t.dtype}")
            self._refs[key] = weakref.ref(st, self._freer(key))
            added += n
        if added:
            self.live += added
            if self.live > self.peak:
                self.peak = self.live
                if self.live > self._snap * 1.01:
                    self._snapshot()
        return added

    def _freer(self, key):
        def free(_ref):
            entry = self._live.pop(key, None)
            self._refs.pop(key, None)
            if entry is not None:
                self.live -= entry[0]
        return free

    def _snapshot(self, n: int = 12) -> None:
        self._snap = self.live
        self.peak_storages = sorted(
            ((b, lab) for b, lab in self._live.values()), reverse=True)[:n]

    def hold_arguments(self, tensors: Iterable[torch.Tensor]) -> None:
        """The step's arguments (state and batch): live from the start."""
        self.argument_bytes += self.hold(tensors, "argument")

    # -- records (trace_hooks) -------------------------------------------

    def record(self, kind: str, name: str, ins=(), outs=(), frame=None,
               **attrs):
        if kind == "kernel":
            args, kwargs = ins
            flops, nbytes = KERNEL_COSTS[name](*args, **kwargs)
            self.kernels[name] += 1
            self.kernel_flops += flops
            self.kernel_bytes += nbytes
        elif kind == "collective" and attrs.get("event") != "wait":
            xla = XLA_KINDS[name]
            for table in (self.collectives,
                          self.per_axis.setdefault(attrs["axis"], {})):
                entry = table.setdefault(xla, {"count": 0, "bytes": 0})
                entry["count"] += 1
                entry["bytes"] += attrs["bytes"]

    def new_pair(self) -> int:
        self._pairs += 1
        return self._pairs

    def key_source(self, rng) -> str:
        return ""

    def site(self, frame) -> str:
        return ""

    # -- aten ops ----------------------------------------------------------

    def aten(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        name = packet.__name__
        ins = _tensors(args, [])
        if kwargs:
            _tensors(kwargs, ins)
        outs = _tensors(out, [])
        if name == "lift_fresh" or (
                name == "_to_copy" and ins and ins[0].device.type == "cpu"
                and outs[0].device.type != "cpu"):
            # a constant made from host data, and (off the CPU) its copy
            # onto the device: host work, not the step's
            return
        self.ops[name] += 1
        if func.namespace == "c10d" or func.is_view or name in _ALLOCATIONS:
            return
        fn = flop_registry.get(packet)
        if fn is not None:
            self.aten_flops += fn(*args, **kwargs, out_val=out)
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.op_bytes[name] += nbytes
        self.aten_bytes += nbytes

    # -- the analysis ------------------------------------------------------

    def analysis(self, n_devices: int) -> dict:
        """The record's ``full`` block (the reference's ``analyse``), with
        the step's output taken as the state it updates in place plus its
        metrics (``alias_bytes`` / ``output_bytes`` set by the caller)."""
        colls = {k: dict(v) for k, v in self.collectives.items()}
        return {
            "per_device_flops": float(self.aten_flops + self.kernel_flops),
            "per_device_bytes": float(self.aten_bytes + self.kernel_bytes),
            "collectives": colls,
            "collectives_by_axis": {a: {k: dict(v) for k, v in t.items()}
                                    for a, t in self.per_axis.items()},
            "collective_bytes_static": sum(v["bytes"] for v in colls.values()),
            "kernel_nodes": dict(self.kernels),
            "aten_ops": int(sum(self.ops.values())),
            "memory": {
                "argument_bytes": int(self.argument_bytes),
                "peak_bytes_estimate": int(self.peak),
                "temp_bytes": int(self.peak - self.argument_bytes),
            },
            "peak_storages": [[int(b), lab] for b, lab in self.peak_storages],
            "n_devices": n_devices,
        }


# ---------------------------------------------------------------------------
# Meta outputs by signature
# ---------------------------------------------------------------------------
#
# torch registers Python decompositions as the meta kernels of most ops
# (``torch._meta_registrations.activate_meta``), at 0.1-1 ms a call; a step
# repeats the same ops on the same shapes block after block and protein
# after protein.  An op whose outputs are all fresh tensors (no view, no
# in-place write, no aliasing between outputs) gets the same output shapes,
# strides and dtypes for the same input metadata and arguments, so the
# second call on ``meta`` makes them with ``empty_strided`` from a cache.

_ATOMS = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)


def _sig(x):
    """A hashable signature of an argument, or raises TypeError."""
    if isinstance(x, _Tensor):
        if x.device.type != "meta":
            raise TypeError("not a meta tensor")
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, _ATOMS):
        return x
    raise TypeError(type(x).__name__)


def _fresh_outputs(func) -> bool:
    """Whether ``func`` returns new tensors only (no alias of an input)."""
    schema = func._schema
    return not func.is_view and all(r.alias_info is None
                                    for r in schema.returns) \
        and all(a.alias_info is None or not a.alias_info.is_write
                for a in schema.arguments)


# (op, signature) -> the outputs' (shape, stride, dtype): shapes only, the
# same in every trace of the process (the probes and roles of a cell repeat
# its ops); op -> whether it returns fresh tensors
_META_CACHE: dict = {}
_FRESH: dict = {}


class _Counter(TorchDispatchMode):
    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        return False

    def __init__(self, trace: CostTrace):
        super().__init__()
        self.trace = trace
        self.cache = _META_CACHE

    def _run(self, func, args, kwargs):
        fresh = _FRESH.get(func)
        if fresh is None:
            fresh = _FRESH[func] = _fresh_outputs(func)
        if not fresh:
            return func(*args, **kwargs)
        try:
            key = (func, _sig(args), _sig(tuple(sorted(kwargs.items()))))
        except TypeError:
            return func(*args, **kwargs)
        metas = self.cache.get(key)
        if metas is not None:
            made = [None if m is None else
                    torch.empty_strided(m[0], m[1], dtype=m[2], device="meta")
                    for m in metas]
            return made[0] if metas.single else tuple(made)
        out = func(*args, **kwargs)
        if isinstance(out, _Tensor):
            outs = [out]
        elif isinstance(out, tuple) and all(
                o is None or isinstance(o, _Tensor) for o in out):
            outs = [o for o in out if o is not None]
        else:
            return out
        # cache only new meta storages, one an output (a decomposition
        # may hand back an input, or views of one buffer)
        st = [id(o.untyped_storage()) for o in outs]
        ins = {id(t.untyped_storage()) for t in _tensors(args, [])}
        if all(o.device.type == "meta" for o in outs) and \
                len(set(st)) == len(st) and not ins.intersection(st):
            metas = _Metas(None if o is None else
                           (tuple(o.shape), o.stride(), o.dtype)
                           for o in ([out] if isinstance(out, _Tensor)
                                     else out))
            metas.single = isinstance(out, _Tensor)
            self.cache[key] = metas
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        trace = self.trace
        outs = _tensors(out, [])
        if outs:
            trace.hold(outs, f"{func.overloadpacket.__name__} "
                       f"{tuple(outs[0].shape)} {outs[0].dtype}")
        if not trace.paused:
            trace.aten(func, args, kwargs, out)
        return out


class _Metas(list):
    single = True


@contextlib.contextmanager
def counting(arguments: Iterable[torch.Tensor] = ()):
    """Count everything run inside the block into the yielded
    :class:`CostTrace`; ``arguments``: the tensors live before the step
    (its state and batch), counted as the arguments.  One trace at a time
    (it is the process's ``trace_hooks.ACTIVE``)."""
    if trace_hooks.ACTIVE is not None:
        raise RuntimeError("an op trace is already being recorded")
    trace = CostTrace()
    trace.hold_arguments(arguments)
    trace_hooks.ACTIVE = trace
    try:
        with _Counter(trace):
            yield trace
    finally:
        trace_hooks.ACTIVE = None
