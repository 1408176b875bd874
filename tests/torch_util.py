"""Helpers shared by the port's parity tests (tests/test_torch_*.py): carry
JAX parameters and numpy inputs into the PyTorch port."""
import dataclasses

import jax
import numpy as np
import torch

from repro_torch import bridge

import torch_threads  # noqa: F401  (one intra-op thread)


def np_tree(params):
    """JAX pytree -> the same nested dict with numpy leaves."""
    return jax.tree_util.tree_map(np.asarray, params)


def randomize_np(tree, seed: int, scale: float = 0.02):
    """``tests/util.py::randomize`` drawn with numpy: every leaf plus
    N(0, scale) noise, so AF2's zero-init output layers do not make a
    comparison vacuous.  For whole-model trees: jax.random over the full
    af2_tiny tree takes ~25 s to compile on the CPU."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(np.shape(x))
                   ).astype(np.asarray(x).dtype), tree)


def af2_tree(cfg, seed: int = 0) -> dict:
    """An AlphaFold2 param tree in the reference's layout (numpy leaves), from
    the port's own initialisation: the reference's shapes and init rules
    (pinned by tests/test_torch_bridge.py), without compiling
    ``jax.jit(init_params)``, which takes 15-40 s of CPU at af2_tiny.
    ``cfg`` is the reference's config."""
    from repro_torch.core.model import AlphaFold2
    model = AlphaFold2(port_cfg(cfg), seed=seed, device="cpu")
    return bridge.state_dict_to_params(model.state_dict())


# the JAX oracles run a few times each: compile them with XLA's cheapest
# backend passes (a third less compile time; the programs are the same)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn):
    """``jax.jit(fn)`` compiled with ``FAST_COMPILE``, once per argument
    structure, shapes and dtypes."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((np.shape(x), np.result_type(x)) for x in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options=FAST_COMPILE)
        return compiled[key](*args)
    return call


def listed(tree):
    """``bridge``'s nested dicts with an unstacked stack's "0", "1", ...
    keys as the reference's lists."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(k.isdigit() for k in tree):
        return [listed(tree[str(i)]) for i in range(len(tree))]
    return {k: listed(v) for k, v in tree.items()}


def lm_tree(model, cfg, seed: int, scale: float = 0.05) -> dict:
    """An LM's param tree in the reference's layout (numpy leaves; stacked
    under ``cfg.scan_layers``), from the port's ``model``'s init plus
    N(0, ``scale``) noise (``randomize_np``): the reference's shapes
    (pinned by each family's init test), without compiling its
    ``init_params`` (1.5-4 s a config on the CPU)."""
    stacked = bridge.LM_STACKED if cfg.scan_layers else ()
    return randomize_np(listed(bridge.state_dict_to_params(
        model.state_dict(), stacked=stacked)), seed, scale)


def load_into(module, params, *, stacked=bridge.STACKED):
    """Load a JAX param tree into a port module through the bridge."""
    return bridge.load_jax_params(module, np_tree(params), stacked=stacked)


def port_cfg(cfg, kernels: bool = True):
    """Port config: every attention / triangle update on the kernel impls
    (their plain versions, on CPU tensors); ``kernels=False``: the
    reference config's own impls."""
    from repro_torch.core import config as tcfg
    ev = tcfg.EvoformerConfig(**dataclasses.asdict(cfg.evoformer))
    ex = tcfg.EvoformerConfig(**dataclasses.asdict(cfg.extra))
    st = tcfg.StructureConfig(**dataclasses.asdict(cfg.structure))
    top = {f.name: getattr(cfg, f.name)
           for f in dataclasses.fields(cfg)
           if f.name not in ("evoformer", "extra", "structure")}
    out = tcfg.AlphaFold2Config(evoformer=ev, extra=ex, structure=st, **top)
    return tcfg.with_kernels(out) if kernels else out


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x)).to(dtype)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def max_abs(a, b) -> float:
    return float(np.max(np.abs(to_np(a) - to_np(b))))
