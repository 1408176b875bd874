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
step sums its gradient over the axis.

Under tensor parallelism the layout has a second axis, ``model``
(``parallel.tensor``): a leaf whose spec names it is split along that dim
for good (the forward reads its slice), and along its data dim, if any, as
above; a leaf such as ``wq.w`` ``P('data', 'model')`` is split on both
dims.  A dim that names both axes is a layout the port does not compute,
and raises naming the leaf.  :func:`data_parallel` tells the
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
    ``shapes``: each leaf's full shape; ``axis``: the data axis;
    ``model``: the tensor-parallel axis (None: none).  A leaf whose spec
    names ``axis`` is split along that dim into ``axis.size`` equal slices
    (the spec's sanitizing guarantees it divides), slice i on the rank at
    coordinate i, and likewise over ``model`` (``mdims``); any other leaf
    is whole on every rank."""

    def __init__(self, specs: Mapping, shapes: Mapping[str, tuple],
                 axis: Axis, model: Optional[Axis] = None):
        self.specs = dict(specs)
        self.shapes = {k: tuple(s) for k, s in shapes.items()}
        self.axis = axis
        self.model = model if model is not None and model.size > 1 else None
        self.dims = {k: (data_dim(s, axis.name) if axis.size > 1 else None)
                     for k, s in self.specs.items()}
        self.mdims = {k: (data_dim(s, self.model.name) if self.model
                          else None) for k, s in self.specs.items()}
        for k, d in self.dims.items():
            if d is not None and d == self.mdims[k]:
                raise ValueError(f"{k}: spec {self.specs[k]} splits one dim "
                                 f"over both {axis.name!r} and "
                                 f"{self.model.name!r}")

    @property
    def sharded(self) -> list:
        return [k for k, d in self.dims.items() if d is not None]

    def _cuts(self, key: str):
        """[(dim, axis)] of the leaf's splits, the model axis first."""
        return [(d, a) for d, a in ((self.mdims[key], self.model),
                                    (self.dims[key], self.axis))
                if d is not None]

    def local_shape(self, key: str) -> tuple:
        shape = list(self.shapes[key])
        for d, a in self._cuts(key):
            shape[d] //= a.size
        return tuple(shape)

    def local(self, key: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full leaf ``full`` (a copy)."""
        for d, a in self._cuts(key):
            n = full.shape[d] // a.size
            full = full.narrow(d, a.index * n, n)
        return full.clone()

    def full(self, key: str, local: torch.Tensor) -> torch.Tensor:
        """The full leaf from every rank's slice ``local`` (every rank of
        the axes calls this together), without autograd."""
        with torch.no_grad():
            for d, a in reversed(self._cuts(key)):
                local = coll.all_gather(local, a, d)
        return local

    def cut(self, prefix: str, module: torch.nn.Module) -> torch.nn.Module:
        """``module`` (the leaves under ``prefix`` of a model being drawn)
        with each leaf replaced by this rank's slice, in place: the
        families' ``init_params(cut=...)`` call it on each module as soon
        as it is drawn, so a rank holds at most one whole module beside its
        slices."""
        with torch.no_grad():
            for name, p in module.named_parameters():
                key = prefix + name
                if tuple(p.shape) != self.local_shape(key):
                    p.data = self.local(key, p.data)
        return module

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
        each leaf's squares summed over the axes it is split over, each
        replicated element counted once."""
        zero = next(iter(tree.values())).new_zeros((), dtype=torch.float32)
        sums = {}
        for k, t in tree.items():
            kind = (self.dims[k] is not None, self.mdims[k] is not None)
            sums[kind] = sums.get(kind, zero) + t.float().square().sum()
        total = sums.get((False, False), zero)
        over = lambda kinds: torch.stack([sums.get(k, zero) for k in kinds])
        # one all-reduce an axis: [both, this axis only]
        if self.axis.size > 1:
            both, data = coll.psum(over([(True, True), (True, False)]),
                                   self.axis).unbind(0)
        else:
            both, data = sums.get((True, True), zero), sums.get(
                (True, False), zero)
        if self.model is not None:
            both, model = coll.psum(torch.stack(
                [both, sums.get((False, True), zero)]), self.model).unbind(0)
        else:
            model = sums.get((False, True), zero)
        return torch.sqrt(total + data + model + both)

    def bytes_held(self, tree: Mapping[str, torch.Tensor]) -> dict:
        """Bytes of ``tree`` on this rank by how each leaf is held, four
        disjoint kinds that sum to the whole: {"sharded" (split over the
        data axis alone), "model_split" (over ``model`` alone), "both",
        "replicated" (over neither)}."""
        out = {"sharded": 0, "model_split": 0, "both": 0, "replicated": 0}
        kinds = {(True, False): "sharded", (False, True): "model_split",
                 (True, True): "both", (False, False): "replicated"}
        for k, t in tree.items():
            kind = kinds[(self.dims[k] is not None,
                          self.mdims[k] is not None)]
            out[kind] += t.numel() * t.element_size()
        return out
