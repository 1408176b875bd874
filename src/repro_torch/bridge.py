"""Carry a JAX parameter pytree, and the optimizer state and EMA parameters
of training, into the port and back, through numpy.

The JAX model's params are nested dicts whose leaves the caller turns into
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``); this module
imports neither JAX nor the JAX package.  Key paths are the same on both
sides, joined with dots; the stacks' leading block axis (the reference scans
over stacked params) is split across the port's ``ModuleList``:
``evoformer.w`` of shape (n, ...) becomes ``evoformer.0.w`` ... ``evoformer.<n-1>.w``
(an LM's scanned ``layers`` likewise, with ``stacked=LM_STACKED``: a MoE's
expert banks (L, E_pad, d, f) become ``layers.<i>.moe.w_gate`` (E_pad, d,
f); the hybrid's ``shared`` block is one block, not a stack; whisper's
``enc_layers`` and ``dec_layers`` are two stacks; the VLM's ``projector``
is no stack).
The reference's ``OptState`` (``step``, ``mu``, ``nu``; ``mu``/``nu`` trees
like the params) and its EMA tree become the port's ``train.optim.OptState``
and EMA dict, keyed like ``model.named_parameters()``.
"""
from __future__ import annotations

import numpy as np
import torch

STACKED = ("extra_stack", "evoformer")
# the LM zoo's scanned layer stacks
LM_STACKED = ("layers", "enc_layers", "dec_layers")


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict (lists of dicts index as ``name.<i>``) -> {dotted key path:
    leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, (list, tuple)):
            v = dict(enumerate(v))
        if isinstance(v, dict):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out


def params_to_state_dict(tree: dict, *, stacked=STACKED) -> dict:
    """JAX param tree (numpy leaves) -> port ``state_dict`` (CPU tensors,
    copies).  ``stacked=()`` for a tree without stacked blocks (one block)."""
    sd = {}
    for key, arr in flatten(tree).items():
        arr = np.asarray(arr)
        head, _, rest = key.partition(".")
        if head in stacked:
            for i in range(arr.shape[0]):
                sd[f"{head}.{i}.{rest}"] = torch.from_numpy(arr[i].copy())
        else:
            sd[key] = torch.from_numpy(arr.copy())
    return sd


class Stacked:
    """One leaf of the reference's tree held as the blocks of a stack:
    ``parts[i]`` is block i's tensor, the leaf their stack along a new
    leading axis."""

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def shape(self) -> tuple:
        return (len(self.parts),) + tuple(self.parts[0].shape)

    @property
    def dtype(self):
        return self.parts[0].dtype


def nest(named: dict, *, stacked=STACKED) -> dict:
    """{dotted key path: leaf} (a ``state_dict``, ``named_parameters``, an
    optimizer moment or EMA dict) -> the reference's nested dict, each
    stack's per-block leaves gathered into one :class:`Stacked` leaf."""
    flat, blocks = {}, {}
    for key, leaf in named.items():
        head, _, rest = key.partition(".")
        if head in stacked:
            idx, _, name = rest.partition(".")
            blocks.setdefault(f"{head}.{name}", {})[int(idx)] = leaf
        else:
            flat[key] = leaf
    for key, per_block in blocks.items():
        flat[key] = Stacked(per_block[i] for i in range(len(per_block)))
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *path, name = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree


def _map_nested(fn, tree: dict) -> dict:
    return {k: _map_nested(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def state_dict_to_params(sd: dict, *, stacked=STACKED) -> dict:
    """Port ``state_dict`` -> nested dict of numpy arrays with the stacks'
    block axis restored: the inverse of :func:`params_to_state_dict`."""
    def to_numpy(leaf):
        if isinstance(leaf, Stacked):
            return np.stack([t.detach().cpu().numpy() for t in leaf.parts])
        return leaf.detach().cpu().numpy()
    return _map_nested(to_numpy, nest(sd, stacked=stacked))


def rank_state_dict(tree: dict, local, *, stacked=STACKED) -> dict:
    """JAX param tree (numpy leaves) -> a rank's ``state_dict``: each
    leaf, keyed as :func:`params_to_state_dict` keys it, cut by ``local(key,
    tensor)`` (``parallel.fsdp.Layout.local``: the rank's slices over
    ``data`` and ``model``) one leaf at a time."""
    sd = {}
    for key, arr in flatten(tree).items():
        arr = np.asarray(arr)
        head, _, rest = key.partition(".")
        if head in stacked:
            for i in range(arr.shape[0]):
                k = f"{head}.{i}.{rest}"
                sd[k] = local(k, torch.from_numpy(np.array(arr[i])))
        else:
            sd[key] = local(key, torch.from_numpy(np.array(arr)))
    return sd


def load_jax_params(module: torch.nn.Module, tree: dict, *,
                    stacked=STACKED) -> torch.nn.Module:
    """Load a JAX param tree into ``module`` (strict: every key must match)."""
    module.load_state_dict(params_to_state_dict(tree, stacked=stacked))
    return module


def opt_state_to_port(step, mu: dict, nu: dict, *, stacked=STACKED):
    """The reference's ``OptState(step, mu, nu)`` (numpy leaves) -> the
    port's ``OptState`` (int step, CPU tensor dicts keyed like
    ``model.named_parameters()``).  An EMA tree goes across as a
    params tree does (:func:`params_to_state_dict`)."""
    from repro_torch.train.optim import OptState
    return OptState(step=int(step),
                    mu=params_to_state_dict(mu, stacked=stacked),
                    nu=params_to_state_dict(nu, stacked=stacked))


def opt_state_to_jax(state, *, stacked=STACKED) -> dict:
    """The port's ``OptState`` -> ``{"step": int32, "mu": tree, "nu": tree}``
    of numpy arrays (``repro.train.optim.OptState(**...)`` rebuilds it)."""
    return {"step": np.asarray(state.step, np.int32),
            "mu": state_dict_to_params(state.mu, stacked=stacked),
            "nu": state_dict_to_params(state.nu, stacked=stacked)}
