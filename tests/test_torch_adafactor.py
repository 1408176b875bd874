"""The port's ``adafactor_like`` and bf16-io LayerNorm against the JAX
package's, on the CPU.

``adafactor_like`` runs three steps of the reference's ``update`` on a small
tree with 1-, 2- and 3-d leaves and a stacked list of 2-d and 1-d blocks
(the reference's scanned layers); the port runs the same steps on the
per-block leaves (``bridge``), through ``update`` (host scalars) and
``apply`` (device scalars).  Parameters within 1e-6 relative (fp32).  The
bf16-io LayerNorm (``set_ln_fp32_io(False)``, the dry run's ``--ln-bf16``)
is held to the reference's at bf16, 3e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import layers as jlayers
from repro.train.optim import adafactor_like as jax_adafactor

from repro_torch import bridge
from repro_torch.nn import layers as tlayers
from repro_torch.train.optim import adafactor_like

import torch_threads  # noqa: F401  (one intra-op thread)

STACKED = ("layers",)


def _tree(rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"a": f(5), "b": f(4, 6), "c": f(3, 4, 5),
            "layers": {"w": f(3, 4, 6), "s": f(3, 6)}}


@pytest.fixture(scope="module")
def reference_steps():
    """(tree, grads, the reference's parameters after the three steps)."""
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    grads = [jax.tree_util.tree_map(
        lambda x: (3.0 * rng.standard_normal(x.shape)).astype(np.float32),
        tree) for _ in range(3)]
    ref = jax_adafactor(1e-2, clip_norm=1.0)
    update = jax.jit(ref.update)
    rp = jax.tree_util.tree_map(jnp.asarray, tree)
    rs = ref.init(rp)
    for g in grads:
        rp, rs = update(jax.tree_util.tree_map(jnp.asarray, g), rs, rp)
    return tree, grads, bridge.params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, rp), stacked=STACKED)


@pytest.mark.parametrize("path", ["update", "apply"])
def test_adafactor_like_matches_reference(path, reference_steps):
    tree, grads, want = reference_steps

    opt = adafactor_like(1e-2, clip_norm=1.0, stacked=STACKED)
    params = bridge.params_to_state_dict(tree, stacked=STACKED)
    state = opt.init(params)
    # the state is keyed by the reference's leaves, factored as its own
    assert sorted(state.nu) == ["a", "b", "c", "layers.s", "layers.w"]
    assert [tuple(t.shape) for t in state.nu["layers.w"]] == [(3, 4), (3, 6)]
    assert [tuple(t.shape) for t in state.nu["layers.s"]] == [(3,), (6,)]
    assert tuple(state.nu["a"].shape) == (5,)
    for i, g in enumerate(grads):
        gt = bridge.params_to_state_dict(g, stacked=STACKED)
        if path == "update":
            params, state = opt.update(gt, state, params)
        else:
            opt.apply(gt, state, params, torch.tensor(float(i + 1)))
    assert sorted(params) == sorted(want)
    for k, w in want.items():
        err = float((params[k] - w).abs().max() / w.abs().max())
        assert err <= 1e-6, (k, err)


def test_layernorm_bf16_io_matches_reference():
    rng = np.random.default_rng(1)
    x = (2.0 * rng.standard_normal((3, 7, 64)) + 0.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    p = tlayers.LayerNorm(64)
    with torch.no_grad():
        p.scale.copy_(torch.from_numpy(scale))
        p.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    default = tlayers.layernorm(p, xt)
    try:
        jlayers.set_ln_fp32_io(False)
        tlayers.set_ln_fp32_io(False)
        got = tlayers.layernorm(p, xt)
        want = jlayers.layernorm({"scale": jnp.asarray(scale),
                                  "bias": jnp.asarray(bias)}, xj)
    finally:
        jlayers.set_ln_fp32_io(True)
        tlayers.set_ln_fp32_io(True)
    assert got.dtype == torch.bfloat16
    want_t = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert float((got.float() - want_t).abs().max()) <= 3e-2
    # the default fp32-io path is back
    assert torch.equal(tlayers.layernorm(p, xt), default)
