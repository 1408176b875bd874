"""Carry a JAX parameter pytree, and the optimizer state and EMA parameters
of training, into the port and back, through numpy.

The JAX model's params are nested dicts whose leaves the caller turns into
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``); this module
imports neither JAX nor the JAX package.  Key paths are the same on both
sides, joined with dots; the stacks' leading block axis (the reference scans
over stacked params) is split across the port's ``ModuleList``:
``evoformer.w`` of shape (n, ...) becomes ``evoformer.0.w`` ... ``evoformer.<n-1>.w``
(an LM's scanned ``layers`` likewise, with ``stacked=LM_STACKED``).
The reference's ``OptState`` (``step``, ``mu``, ``nu``; ``mu``/``nu`` trees
like the params) and its EMA tree become the port's ``train.optim.OptState``
and EMA dict, keyed like ``model.named_parameters()``.
"""
from __future__ import annotations

import numpy as np
import torch

STACKED = ("extra_stack", "evoformer")
LM_STACKED = ("layers",)     # the LM zoo's scanned layer stack


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


def state_dict_to_params(sd: dict, *, stacked=STACKED) -> dict:
    """Port ``state_dict`` -> nested dict of numpy arrays with the stacks'
    block axis restored: the inverse of :func:`params_to_state_dict`."""
    flat, blocks = {}, {}
    for key, t in sd.items():
        arr = t.detach().cpu().numpy()
        head, _, rest = key.partition(".")
        if head in stacked:
            idx, _, leaf = rest.partition(".")
            blocks.setdefault(f"{head}.{leaf}", {})[int(idx)] = arr
        else:
            flat[key] = arr
    for key, per_block in blocks.items():
        flat[key] = np.stack([per_block[i] for i in range(len(per_block))])
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree


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
