"""Fully sharded data parallelism over rank processes (ZeRO-3): each
parameter leaf, and its optimizer moments, lives on each rank of the data
axis as that rank's slice along the dim its sanitized partition spec names
the axis, and a layer's full parameters are gathered just before the layer
uses them.  This is the port's counterpart of what the reference's GSPMD
step compiles from its partition rules under ``cfg.fsdp``
(``repro/train/trainstep.py``'s ``make_lm_train_step`` on a
("data", "model") mesh); the step itself is ``train.trainstep``'s.

* :class:`Layout`: the sanitized spec of every key, the dim each sharded
  leaf is split along (None: replicated), and this rank's slices.
* :meth:`Layout.shard_` cuts a full model into this rank's slices in
  place and marks each layer of the stacks (``bridge.LM_STACKED``) with
  the dims of its sharded leaves.
* :meth:`Layout.view`: the model as a forward sees it: every leaf cast to
  the compute dtype through autograd (the cast is elementwise, so casting
  the slice before the gather is exact and halves the gather's bytes); the
  leaves outside the layer stacks (embedding, head, final norm, a
  projector or shared block) gathered there, at the forward's entry; the
  layers' leaves left as slices, their marks carried along.
* :func:`gathering` wraps a family's layer function (``models.dense.remat``
  wraps each one): a marked layer's sharded leaves are gathered by
  ``collectives.all_gather`` inside the call, whose backward reduce-
  scatters their gradient, so the collective counters and the op trace
  see every gather.  Under ``remat="layer"`` the call is what
  ``torch.utils.checkpoint`` recomputes, so the recompute gathers again,
  as the reference's rematerialised program would.

A leaf whose sanitized spec names no data axis (a norm's scale, a bias, a
dim the axis does not divide: nothing is padded) is replicated, and the
step sums its gradient over the axis.  :func:`data_parallel` tells the
forward which axis the batch is split over (the MoE router's statistics
are the global batch's).
"""
from __future__ import annotations

import contextlib
import copy
from typing import Mapping, Optional

import torch

from repro_torch import bridge
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.mesh_utils import Axis

# the attribute of a layer module that marks it for gathering
_MARK = "_fsdp_gather"
_DATA_AXIS: list = []


def data_dim(spec, name: str) -> Optional[int]:
    """The dim of ``spec`` that names mesh axis ``name`` (alone or in a
    tuple), or None."""
    for i, entry in enumerate(spec):
        if entry == name or (isinstance(entry, tuple) and name in entry):
            return i
    return None


def in_stack(key: str) -> bool:
    """Whether ``key`` is a leaf of one layer of a stack (``layers.3.*``)."""
    head, _, rest = key.partition(".")
    return head in bridge.LM_STACKED and rest.partition(".")[0].isdigit()


class Gather:
    """A layer's mark: the dims of its sharded leaves by name relative to
    the layer, and the axis they are split over.  Calling it on the layer
    (as a view holds it: slices in the compute dtype) returns a copy whose
    sharded leaves are gathered, through autograd.  Copies of a module
    share the mark."""

    def __init__(self, axis: Axis, dims: Mapping[str, int]):
        self.axis, self.dims = axis, dict(dims)

    def __deepcopy__(self, memo):
        return self

    def __call__(self, layer: torch.nn.Module) -> torch.nn.Module:
        memo = {}
        for name, t in layer.named_parameters():
            d = self.dims.get(name)
            memo[id(t)] = t if d is None else coll.all_gather(t, self.axis, d)
        out = copy.deepcopy(layer, memo)
        setattr(out, _MARK, None)
        return out


def gathering(fn):
    """``fn(layer, *args)`` with a marked layer gathered first (an
    unmarked one, as every layer is outside a sharded step, passes as it
    is)."""
    def call(layer, *args, **kw):
        mark = getattr(layer, _MARK, None)
        return fn(layer if mark is None else mark(layer), *args, **kw)
    return call


@contextlib.contextmanager
def data_parallel(axis: Axis):
    """Within: the forward's batch is this rank's rows of a batch split
    over ``axis`` (:func:`current_data_axis`).  The backward belongs
    inside too: a remat recompute runs the forward again.  A module global,
    not a context variable: the autograd engine's device threads read it."""
    _DATA_AXIS.append(axis)
    try:
        yield axis
    finally:
        _DATA_AXIS.pop()


def current_data_axis() -> Optional[Axis]:
    """The axis of the innermost :func:`data_parallel`, or None."""
    return _DATA_AXIS[-1] if _DATA_AXIS else None


class Layout:
    """Where every parameter leaf lives on this rank.  ``specs``: the
    sanitized spec of each key (``train.trainstep.state_shardings``);
    ``shapes``: each leaf's full shape; ``axis``: the data axis.  A leaf
    whose spec names ``axis`` is split along that dim into ``axis.size``
    equal slices (the spec's sanitizing guarantees it divides), slice i on
    the rank at coordinate i; any other leaf is whole on every rank."""

    def __init__(self, specs: Mapping, shapes: Mapping[str, tuple],
                 axis: Axis):
        self.specs = dict(specs)
        self.shapes = {k: tuple(s) for k, s in shapes.items()}
        self.axis = axis
        self.dims = {k: (data_dim(s, axis.name) if axis.size > 1 else None)
                     for k, s in self.specs.items()}

    @property
    def sharded(self) -> list:
        return [k for k, d in self.dims.items() if d is not None]

    def local_shape(self, key: str) -> tuple:
        shape, d = list(self.shapes[key]), self.dims[key]
        if d is not None:
            shape[d] //= self.axis.size
        return tuple(shape)

    def local(self, key: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full leaf ``full`` (a copy)."""
        d = self.dims[key]
        if d is None:
            return full.clone()
        n = full.shape[d] // self.axis.size
        return full.narrow(d, self.axis.index * n, n).clone()

    def full(self, key: str, local: torch.Tensor) -> torch.Tensor:
        """The full leaf from every rank's slice ``local`` (every rank of
        the axis calls this together), without autograd."""
        d = self.dims[key]
        with torch.no_grad():
            return local if d is None else coll.all_gather(local, self.axis,
                                                           d)

    def shard_(self, model: torch.nn.Module) -> torch.nn.Module:
        """Cut ``model``'s full leaves to this rank's slices in place (a leaf
        already at its local shape stays) and mark the stacks' layers."""
        with torch.no_grad():
            for key, p in model.named_parameters():
                if tuple(p.shape) == self.local_shape(key):
                    continue
                if tuple(p.shape) != self.shapes[key]:
                    raise ValueError(f"{key}: shape {tuple(p.shape)} is "
                                     f"neither {self.shapes[key]} nor its "
                                     f"slice {self.local_shape(key)}")
                p.data = self.local(key, p.data)
        for stack in bridge.LM_STACKED:
            for i, layer in enumerate(getattr(model, stack, ())):
                pre = f"{stack}.{i}."
                dims = {k[len(pre):]: d for k, d in self.dims.items()
                        if k.startswith(pre) and d is not None}
                setattr(layer, _MARK, Gather(self.axis, dims) if dims
                        else None)
        return model

    def view(self, model: torch.nn.Module, dtype: torch.dtype):
        """``model`` as a forward reads it: each leaf cast to ``dtype``
        through autograd, the leaves outside the stacks gathered; a copy
        of the module tree holding those tensors."""
        memo = {}
        for key, p in model.named_parameters():
            t = p.to(dtype)
            d = self.dims[key]
            if d is not None and not in_stack(key):
                t = coll.all_gather(t, self.axis, d)
            memo[id(p)] = t
        return copy.deepcopy(model, memo)

    def global_norm(self, tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """fp32 L2 norm of the full tensors whose slices (sharded keys) or
        copies (replicated keys, the same on every rank) ``tree`` holds:
        the sharded leaves' squares summed over the axis, each replicated
        element counted once."""
        zero = next(iter(tree.values())).new_zeros((), dtype=torch.float32)
        sq = lambda keys: sum((tree[k].float().square().sum() for k in keys),
                              zero)
        shard = sq(self.sharded)
        if self.axis.size > 1:
            shard = coll.psum(shard, self.axis)
        return torch.sqrt(shard + sq([k for k in tree
                                      if self.dims[k] is None]))

    def bytes_held(self, tree: Mapping[str, torch.Tensor]) -> dict:
        """{"sharded": bytes, "replicated": bytes} of ``tree`` on this
        rank."""
        out = {"sharded": 0, "replicated": 0}
        for k, t in tree.items():
            kind = "replicated" if self.dims[k] is None else "sharded"
            out[kind] += t.numel() * t.element_size()
        return out
