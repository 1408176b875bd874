"""Collectives over a mesh axis, with the transposes the reference's
autodiff relies on (the port's counterparts of ``jax.lax.psum``, ``pmean``,
``pmax`` and the tiled ``all_gather`` / ``all_to_all`` that
``repro/parallel/dap.py:46-60`` uses).

Each differentiable collective is a ``torch.autograd.Function`` whose
backward is the reference's transpose:

* ``psum`` -> ``psum`` (the BP exchange and its backward all-reduce);
* tiled ``all_gather`` -> reduce-scatter (sum) of the cotangent;
* tiled ``all_to_all`` -> the inverse ``all_to_all``.

Routes.  How each kind reaches the wire depends on the axis group's backend
and the tensor's device, chosen here explicitly and listed by
:func:`routes` (the launchers print it); nothing switches paths on an
error.  NCCL takes every kind natively.  gloo takes CPU tensors natively
except the reduce-scatter, which runs as an all-reduce plus this rank's
slice; a CUDA tensor under gloo (ranks sharing one card) is staged through
host memory: copied to the host, reduced there, copied back.

``COUNTS`` counts the collectives issued, by the kind on the wire (the
backward of a gather counts as a ``reduce_scatter``); a collective over an
axis of extent 1 is the identity and issues nothing.  While an op trace
records (``trace_hooks``), each collective is a node of it,
with its kind, axis name and bytes (``op_walk.collective_axis_counts``
counts them per (kind, axis)); the async gather of the overlapped DAP
schedule is a start node and a wait node linked by an id.
"""
from __future__ import annotations

import collections
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch import trace_hooks
from repro_torch.parallel.mesh_utils import Axis

KINDS = ("psum", "pmax", "all_gather", "all_to_all", "reduce_scatter")
COUNTS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    COUNTS.clear()


def counts() -> dict:
    return {k: COUNTS[k] for k in KINDS}


def _issued(kind: str, axis: Axis, nbytes: int, event: str = "sync"):
    """Count one collective of ``kind`` over ``axis`` moving ``nbytes``
    (its output); returns the trace's pair id of an async ``start``."""
    COUNTS[kind] += 1
    if trace_hooks.ACTIVE is not None:
        return trace_hooks.record_collective(kind, axis.name, nbytes,
                                             event=event)
    return None


def _staged(x: torch.Tensor, group) -> bool:
    """True where a CUDA tensor goes to gloo: staged through the host."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def routes(group, device) -> dict:
    """{kind: how it runs} for ``group``'s backend and tensors on
    ``device`` (the table the launchers print)."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        return {k: f"nccl {k}" for k in KINDS}
    stage = (", staged through host memory"
             if torch.device(device).type == "cuda" else "")
    return {"psum": "gloo all_reduce(SUM)" + stage,
            "pmax": "gloo all_reduce(MAX)" + stage,
            "all_gather": "gloo all_gather" + stage,
            "all_to_all": "gloo all_to_all_single" + stage,
            "reduce_scatter": "gloo all_reduce(SUM) + local slice" + stage}


# ---------------------------------------------------------------------------
# Primitives (no autograd)
# ---------------------------------------------------------------------------

def _all_reduce_(x: torch.Tensor, axis: Axis, op=dist.ReduceOp.SUM,
                 kind: str = "psum") -> torch.Tensor:
    """In place over ``axis``; returns ``x`` (contiguous)."""
    _issued(kind, axis, x.numel() * x.element_size())
    if _staged(x, axis.group):
        h = x.cpu()
        dist.all_reduce(h, op=op, group=axis.group)
        x.copy_(h)
    else:
        dist.all_reduce(x, op=op, group=axis.group)
    return x


def _gather_list(x: torch.Tensor, axis: Axis, async_op: bool = False):
    """(parts, work, pair): every rank's ``x`` in axis order; ``work`` is
    the pending op when ``async_op`` (None otherwise), ``pair`` the trace's
    id of its start (None with no trace)."""
    src = x.detach().contiguous()
    if _staged(src, axis.group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    work = dist.all_gather(parts, src, group=axis.group, async_op=async_op)
    pair = _issued("all_gather", axis,
                   axis.size * src.numel() * src.element_size(),
                   "start" if async_op else "sync")
    return parts, work, pair


def _all_to_all_stacked(inp: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``inp`` (n, ...): chunk j goes to rank j; returns (n, ...) whose chunk
    i came from rank i."""
    inp = inp.contiguous()
    _issued("all_to_all", axis, inp.numel() * inp.element_size())
    staged = _staged(inp, axis.group)
    src = inp.cpu() if staged else inp
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=axis.group)
    return out.to(inp.device) if staged else out


def _reduce_scatter_stacked(inp: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``inp`` (n, ...): the sum over ranks of chunk ``axis.index``."""
    inp = inp.contiguous()
    _issued("reduce_scatter", axis, inp[0].numel() * inp.element_size())
    if dist.get_backend(axis.group) == "nccl":
        out = torch.empty_like(inp[0])
        dist.reduce_scatter_tensor(out, inp, group=axis.group)
        return out
    staged = _staged(inp, axis.group)
    h = inp.cpu() if staged else inp.clone()
    dist.all_reduce(h, group=axis.group)
    mine = h[axis.index]
    return mine.to(inp.device) if staged else mine


def _flat_psum(tensors: Sequence[torch.Tensor], axis: Axis,
               op=dist.ReduceOp.SUM, kind: str = "psum") -> list:
    """All-reduce ``tensors`` in one call per dtype (one buffer each);
    returns new tensors."""
    out = [None] * len(tensors)
    by_dtype = collections.defaultdict(list)
    for i, t in enumerate(tensors):
        by_dtype[t.dtype].append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        _all_reduce_(flat, axis, op=op, kind=kind)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    return out


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------

class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, *xs):
        ctx.axis = axis
        return tuple(_flat_psum(xs, axis))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_flat_psum(gs, ctx.axis))


def psum(xs, axis: Axis):
    """Sum over ``axis`` of a tensor or a tuple of tensors (one all-reduce
    per dtype for the whole tuple); the backward all-reduces the
    cotangents."""
    if axis.size == 1:
        return xs
    if isinstance(xs, torch.Tensor):
        return _PSum.apply(axis, xs)[0]
    return _PSum.apply(axis, *xs)


def pmean(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else psum(x, axis) / axis.size


@torch.no_grad()
def pmax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Max over ``axis`` (no gradient)."""
    if axis.size == 1:
        return x
    return _flat_psum([x], axis, op=dist.ReduceOp.MAX, kind="pmax")[0]


def _reduce_scatter_dim(g: torch.Tensor, axis: Axis, dim: int):
    """Sum over ranks of this rank's ``dim``-slice of ``g`` (tiled)."""
    chunks = torch.stack(g.chunk(axis.size, dim))
    return _reduce_scatter_stacked(chunks, axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        parts, _, _ = _gather_list(x, axis)
        return torch.cat([p.to(x.device) for p in parts], dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, ctx.axis, ctx.dim), None, None


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """Tiled all-gather: every rank's ``x`` concatenated along ``dim`` in
    axis order; the backward reduce-scatters (sums) the cotangent."""
    if axis.size == 1:
        return x
    return _AllGather.apply(x, axis, dim)


def _a2a(x: torch.Tensor, axis: Axis, split_dim: int, concat_dim: int):
    out = _all_to_all_stacked(torch.stack(x.chunk(axis.size, split_dim)), axis)
    return torch.cat(out.unbind(0), concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = (axis, split_dim, concat_dim)
        return _a2a(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim = ctx.args
        return _a2a(g, axis, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, axis: Axis, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Tiled all-to-all: ``x`` split in ``axis.size`` chunks along
    ``split_dim``, chunk j sent to rank j, the received chunks concatenated
    along ``concat_dim`` in axis order; the backward is the inverse
    all-to-all."""
    if axis.size == 1:
        return x
    return _AllToAll.apply(x, axis, split_dim, concat_dim)


# ---------------------------------------------------------------------------
# An all-gather in flight (the overlapped DAP schedule's prefetch)
# ---------------------------------------------------------------------------

class _GatherWait(torch.autograd.Function):
    """The consume half: waits for the gather started from ``src`` (the
    first time) and returns its result; the backward reduce-scatters the
    cotangent onto ``src``."""

    @staticmethod
    def forward(ctx, src, pending):
        ctx.axis, ctx.dim = pending.axis, pending.dim
        if pending.work is not None:
            if trace_hooks.ACTIVE is not None:
                trace_hooks.record_collective(
                    "all_gather", pending.axis.name, 0, event="wait",
                    pair=pending.pair)
            pending.work.wait()
            pending.work = None
        return torch.cat([p.to(src.device) for p in pending.parts], pending.dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, ctx.axis, ctx.dim), None


class Pending:
    """A tiled all-gather of ``src`` along ``dim`` over ``axis``, started
    asynchronously (``async_op=True``) when made; :meth:`wait` returns the
    gathered tensor, differentiable back to ``src``.  The issue half reads
    ``src`` without recording anything for autograd.  Only the first
    :meth:`wait` waits: a later one (the consuming block's recompute under
    ``torch.utils.checkpoint``) returns the gathered tensor again with no
    communication, so the Pending holds the gathered parts until it is
    dropped."""

    def __init__(self, src: torch.Tensor, axis: Axis, dim: int = 0):
        self.src, self.axis, self.dim = src, axis, dim
        self.parts, self.work, self.pair = _gather_list(src, axis,
                                                        async_op=True)

    def wait(self) -> torch.Tensor:
        return _GatherWait.apply(self.src, self)


def all_gather_start(x: torch.Tensor, axis: Axis, dim: int = 0) -> Pending:
    return Pending(x, axis, dim)


# ---------------------------------------------------------------------------
# Trees of tensors (gradients; no autograd)
# ---------------------------------------------------------------------------

@torch.no_grad()
def psum_tree(tree: dict, axes: Sequence[Axis]) -> dict:
    """Sum a dict of tensors over each of ``axes`` in turn, one all-reduce
    per axis and dtype (the leaves share a buffer)."""
    keys = list(tree)
    vals = [tree[k] for k in keys]
    for axis in axes:
        if axis.size > 1:
            vals = _flat_psum(vals, axis)
    return dict(zip(keys, vals))


def axes_size(axes: Sequence[Axis]) -> int:
    n = 1
    for a in axes:
        n *= a.size
    return n


@torch.no_grad()
def pmean_tree(tree: dict, axes: Sequence[Axis]) -> dict:
    n = axes_size(axes)
    if n == 1:
        return dict(tree)
    return {k: v / n for k, v in psum_tree(tree, axes).items()}


def dp_index(axes: Sequence[Axis]) -> int:
    """This rank's index over ``axes`` (outer first), e.g. its data-parallel
    replica over (pod, data)."""
    idx = 0
    for a in axes:
        idx = idx * a.size + a.index
    return idx


def gather_rows(x: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    """Every replica's rows of ``x`` (dim 0), concatenated in replica order
    over ``axes`` (no gradient): the inverse of taking rows by
    :func:`dp_index`."""
    with torch.no_grad():
        for a in reversed(axes):
            if a.size > 1:
                parts, _, _ = _gather_list(x, a)
                x = torch.cat([p.to(x.device) for p in parts], 0)
    return x
