"""The plain versions of the port's kernels (what CPU tensors run) against
the JAX package's references.

K1 (gated bias attention) vs ``repro.kernels.ref.evo_attention_ref``; K3
(triangle-multiplicative update) vs ``repro.core.evoformer.triangle_mult``
(the reference impl) and ``triangle_mult_fused(impl="chunked")``.  fp32
throughout: attention 2e-4 and triangle 1e-5, the reference's own kernel
tolerances (tests/test_kernels.py, tests/test_triangle.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import evoformer as jevo
from repro.core.config import af2_tiny
from repro.kernels.ref import evo_attention_ref as jax_evo_attention_ref
from repro.nn.attention import attention_reference as jax_attention

from repro_torch import bridge
from repro_torch.core import evoformer as tevo
from repro_torch.core.config import EvoformerConfig
from repro_torch.kernels import ops, ref

from torch_util import load_into, max_abs, randomize_np, t


@pytest.mark.parametrize("biased,gated", [(True, True), (False, True),
                                          (True, False), (False, False)])
@pytest.mark.parametrize("L,S,H,C", [(3, 16, 2, 4), (2, 13, 2, 8)])
def test_evo_attention_plain_matches_jax(L, S, H, C, biased, gated):
    rng = np.random.default_rng(S * 10 + C)
    q, k, v, g = (rng.standard_normal((L, S, H, C)).astype(np.float32)
                  for _ in range(4))
    bias = rng.standard_normal((H, S, S)).astype(np.float32)
    bias[:, :, -3:] = -1e9                       # masked keys (mask_bias)
    jb = jnp.asarray(bias) if biased else None
    if gated:
        want = jax_evo_attention_ref(q, k, v, jb, g)
    else:
        want = jax_attention(q, k, v, bias=jb)
    got = ref.evo_attention_ref(t(q), t(k), t(v), t(bias) if biased else None,
                                t(g) if gated else None)
    assert max_abs(got, want) < 2e-4


def test_evo_attention_ops_dispatch_cpu():
    """On CPU tensors the ops run the plain version; nobias == bias None."""
    rng = np.random.default_rng(0)
    q, k, v, g = (t(rng.standard_normal((2, 9, 2, 4))) for _ in range(4))
    before = ops.launch_counts()
    np.testing.assert_array_equal(ops.evo_attention_nobias(q, k, v, g),
                                  ref.evo_attention_ref(q, k, v, None, g))
    assert ops.launch_counts() == before          # the plain path never counts


EV = af2_tiny().evoformer


@pytest.fixture(scope="module")
def tri_params():
    """The reference's layout, drawn without JAX (its eager init and noise
    compile every op for every leaf shape): the port's init plus N(0, 0.2)
    numpy noise."""
    mod = tevo.TriangleMult(EV.c_z, EV.c_hidden_mul,
                            generator=torch.Generator().manual_seed(0))
    return randomize_np(bridge.state_dict_to_params(mod.state_dict(),
                                                    stacked=()), 3, 0.2)


@pytest.mark.parametrize("outgoing", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("r", [16, 11])
def test_triangle_plain_matches_jax(tri_params, outgoing, masked, r):
    rng = np.random.default_rng(r)
    z = rng.standard_normal((r, r, EV.c_z)).astype(np.float32)
    km = np.ones((r,), np.float32)
    if masked:
        km[-4:] = 0.0
    k_mask = km if masked else None
    port = load_into(tevo.TriangleMult(EV.c_z, EV.c_hidden_mul,
                                       generator=torch.Generator()),
                     tri_params, stacked=())
    # JAX reference impl vs the port's kernel path on the same z
    want = jevo.triangle_mult(tri_params, z, outgoing=outgoing,
                              k_mask=k_mask)
    pcfg = EvoformerConfig(c_z=EV.c_z, c_hidden_mul=EV.c_hidden_mul,
                           tri_mult_impl="pallas")
    got = tevo.tri_mult_apply(port, pcfg, t(z), outgoing=outgoing,
                              k_mask=t(km) if masked else None)
    assert max_abs(got, want) < 1e-5
    # kernel contract on oriented, LN'd operands vs the JAX chunked impl
    x = jevo.nn.layernorm(tri_params["ln_in"], z)
    xab = x if outgoing else x.swapaxes(0, 1)
    want_f = jevo.triangle_mult_fused(tri_params, xab, xab, x, impl="chunked",
                                      chunk=4, k_mask=k_mask)
    tx = t(x)
    txab = tx if outgoing else tx.transpose(0, 1)
    packed = (*tevo.tri_mult_packed_weights(port), port.ln_out.scale,
              port.ln_out.bias, port.out.w, port.out.b, port.gate.w,
              port.gate.b)
    with torch.no_grad():
        got_f = ref.triangle_mult_ref(txab, txab, tx, *packed,
                                      k_mask=t(km) if masked else None)
    assert max_abs(got_f, want_f) < 1e-5
