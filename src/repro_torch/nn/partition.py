"""Regex-path partition rules (t5x-style) -> partition specs by key path
(counterpart of ``repro/nn/partition.py``).

A rule list is ``[(regex, P or callable), ...]``; the first regex matching
a parameter's path wins, and a path no rule matches is replicated (``P()``).
A path is the port's dotted ``state_dict`` key joined with ``/``
(``layers.3.wq.w`` -> ``layers/3/wq/w``).  A spec :class:`P` names, for
each leading dim of the parameter, the mesh axis (or tuple of axes) it is
split over, or None; dims past the spec's length are whole.

The stacked layer axis is mapped, not copied: under ``cfg.scan_layers``
the reference stacks every layer's leaf along a leading axis, and its rules
(``lay(...)``) put a leading None on that axis.  The port holds one leaf a
layer (``bridge.LM_STACKED``: ``layers``, ``enc_layers``, ``dec_layers``
are ``ModuleList``s), so :func:`make_param_specs` drops that leading entry
for a leaf under one of those lists (``stacked``); the rules themselves are
the reference's.

The reference's ``make_shardings``, ``shape_dtype_tree`` and ``constrain``
have no counterpart: the port's data-parallel step
(``train.trainstep.make_lm_train_step``) places each leaf by its sanitized
spec itself, sizes nothing through abstract shapes, and holds each rank's
rows of the batch, so there is no layout for a constraint to pin.
"""
from __future__ import annotations

import re
from typing import Any, Mapping, Sequence

Rules = Sequence[tuple[str, Any]]


class P(tuple):
    """A partition spec: one entry per leading dim, each None, a mesh axis
    name or a tuple of names (``jax.sharding.PartitionSpec``'s
    counterpart)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def tree_paths(named: Mapping[str, Any]) -> list[str]:
    """The '/'-joined paths of a ``state_dict`` / ``named_parameters``
    mapping, in its order."""
    return [key.replace(".", "/") for key in named]


def spec_for_path(path: str, rules: Rules, leaf=None) -> P:
    for pattern, spec in rules:
        if re.search(pattern, path):
            if callable(spec) and not isinstance(spec, P):
                return spec(path, leaf)
            return spec
    return P()


def _under_stack(path: str, stacked: Sequence[str]) -> bool:
    head, _, rest = path.partition("/")
    return head in stacked and rest.partition("/")[0].isdigit()


def make_param_specs(named: Mapping[str, Any], rules: Rules, *,
                     stacked: Sequence[str] = ()) -> dict:
    """{key: P} for a mapping of key -> leaf (a tensor, or a shape tuple):
    the first matching rule's spec, with its leading
    entry dropped for a leaf under a list of ``stacked`` (the rules'
    stacked layer axis; pass ``bridge.LM_STACKED`` when the rules were made
    with ``cfg.scan_layers``).  A spec of higher rank than its leaf
    raises."""
    specs = {}
    for key, leaf in named.items():
        path = key.replace(".", "/")
        spec = spec_for_path(path, rules, leaf)
        if len(spec) and _under_stack(path, stacked):
            if spec[0] is not None:
                raise ValueError(f"rule for {path} shards the stacked layer "
                                 f"axis: {spec}")
            spec = P(*spec[1:])
        ndim = (len(leaf) if isinstance(leaf, tuple)
                else getattr(leaf, "ndim", None))
        if ndim is not None and len(spec) > ndim:
            raise ValueError(f"rule for {path} has rank {len(spec)} > param "
                             f"rank {ndim}")
        specs[key] = spec
    return specs
