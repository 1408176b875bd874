"""The port's Evoformer block against the JAX block, at af2_tiny widths.

Same randomized params on both sides (the port's block init plus N(0,
0.02) numpy noise, carried into the reference's layout by
``repro_torch.bridge``; ``tests/test_torch_bridge.py`` pins the port's
init to the reference's shapes and rules) and the same numpy inputs.  JAX runs its ``chunked`` impls (its Pallas
kernels do not run on the installed JAX); the port runs ``evo_pallas`` /
``pallas``, which on CPU tensors are the kernels' plain versions.

Tolerances: fp32 1e-5 absolute, the reference's module tolerance (observed
max |Δ| 7e-7 on outputs of magnitude ~4).  bf16 3e-2 times the output's
scale (observed 0.03 on magnitude ~3.7, two bf16 ulps): both sides round
every op's output to bf16, but in different places — the port's kernel
path keeps the attention probabilities and the triangle LayerNorm input in
fp32 where the JAX chunked path rounds them to bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import evoformer as jevo
from repro.core.config import af2_tiny
from repro.nn import layers as jnn

from repro_torch import bridge
from repro_torch.core import evoformer as tevo
from repro_torch.core.config import EvoformerConfig
from repro_torch.nn.layers import Policy

from torch_util import load_into, randomize_np, to_np

CFG = af2_tiny()
S, R = CFG.n_seq, CFG.n_res


@pytest.fixture(scope="module")
def block_params():
    """Randomized block params per stack (the variants share one tree),
    drawn without JAX: its eager init and per-leaf noise compile every op
    for every leaf shape (~15 s)."""
    cache = {}

    def get(stack):
        if stack not in cache:
            block = tevo.EvoformerBlock(_port_cfg(getattr(CFG, stack)),
                                        generator=torch.Generator()
                                        .manual_seed(0))
            cache[stack] = randomize_np(bridge.state_dict_to_params(
                block.state_dict(), stacked=()), 7)
        return cache[stack]
    return get


def _port_cfg(ev):
    return EvoformerConfig(**{**dataclasses.asdict(ev),
                              "attention_impl": "evo_pallas",
                              "tri_mult_impl": "pallas"})


def _inputs(ev, seed=0):
    rng = np.random.default_rng(seed)
    msa = rng.standard_normal((S, R, ev.c_m)).astype(np.float32)
    z = rng.standard_normal((R, R, ev.c_z)).astype(np.float32)
    rows = np.ones((S,), np.float32)
    rows[-2:] = 0.0
    res = np.ones((R,), np.float32)
    res[-5:] = 0.0
    return msa, z, rows, res


@pytest.mark.parametrize("stack,variant,masked,dtype", [
    ("evoformer", "parallel", False, "float32"),
    ("evoformer", "parallel", True, "float32"),
    ("evoformer", "parallel", False, "bfloat16"),
    ("evoformer", "parallel", True, "bfloat16"),
    ("evoformer", "af2", True, "float32"),
    ("extra", "parallel", True, "bfloat16"),   # global column attention
])
def test_evoformer_block_matches_jax(block_params, stack, variant, masked,
                                     dtype):
    ev = dataclasses.replace(getattr(CFG, stack), variant=variant,
                             attention_impl="chunked", tri_mult_impl="chunked")
    params = block_params(stack)
    msa, z, rows, res = _inputs(ev)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jmasks = jevo.EvoMasks(jnp.asarray(rows), jnp.asarray(res)) if masked else None
    # one compile of the whole block (op by op, JAX compiles every op)
    m_j, z_j = jax.jit(lambda p, m, zz, mk: jevo.evoformer_block(
        jnn.Policy(compute_dtype=jdt).cast(p), ev, m, zz, masks=mk))(
        params, jnp.asarray(msa, jdt), jnp.asarray(z, jdt), jmasks)

    pev = _port_cfg(ev)
    block = load_into(tevo.EvoformerBlock(pev, generator=torch.Generator()),
                      params, stacked=())
    tmasks = (tevo.EvoMasks(torch.from_numpy(rows), torch.from_numpy(res))
              if masked else None)
    with torch.no_grad():
        m_t, z_t = tevo.evoformer_block(
            Policy(compute_dtype=tdt).cast(block), pev,
            torch.from_numpy(msa).to(tdt), torch.from_numpy(z).to(tdt),
            masks=tmasks)
    assert m_t.dtype == tdt and z_t.dtype == tdt
    for got, want in ((m_t, m_j), (z_t, z_j)):
        got, want = to_np(got), to_np(want)
        assert np.isfinite(got).all()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        else:
            scale = max(1.0, float(np.abs(want).max()))
            assert np.abs(got - want).max() <= 3e-2 * scale


@pytest.mark.parametrize("kind,match", [
    ("attention_impl", "unknown attention impl"),
    ("tri_mult_impl", "unknown tri_mult impl"),
    ("opm_impl", "unknown opm impl")])
def test_unported_impl_raises_actionable(kind, match):
    """An impl that neither package has raises a ValueError naming it (the
    reference's defaults, ``chunked`` / ``chunked`` / ``fused``, and
    ``naive`` OPM run: ``tests/test_torch_evoformer_impls.py``)."""
    ev = dataclasses.replace(CFG.evoformer, **{kind: "flash"})
    block = tevo.EvoformerBlock(ev, generator=torch.Generator().manual_seed(0))
    msa, z, _, _ = _inputs(ev)
    with pytest.raises(ValueError, match=match):
        tevo.evoformer_block(block, ev, torch.from_numpy(msa),
                             torch.from_numpy(z))
