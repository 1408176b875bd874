"""The port's LM attention (``repro_torch.nn.attention``, ``nn.rope``) and
the plain version of kernel K6 against the JAX package, on the CPU.

Inputs are numpy arrays from a seed.  Tolerances: K6's plain version
against ``repro.kernels.ref.flash_attention_ref`` 2e-4 at fp32 and 3e-2 at
bf16, the reference's own kernel tolerances (tests/test_kernels.py:9-15);
the attention functions and RoPE at fp32 within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.nn import attention as jatt
from repro.nn.rope import apply_rope as jax_rope

from repro_torch.kernels import ops, ref
from repro_torch.nn import attention as tatt
from repro_torch.nn.rope import apply_rope

from torch_util import max_abs, t

TORCH_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def jj(fn, *args, **kw):
    """``fn(*args, **kw)`` under jax.jit (one compile is quicker on the CPU
    than JAX's op-by-op dispatch); keyword values are closed over."""
    return jax.jit(lambda *a: fn(*a, **kw))(*args)


def _qkv(seed, q_shape, kv_shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(q_shape).astype(np.float32),
            rng.standard_normal(kv_shape).astype(np.float32),
            rng.standard_normal(kv_shape).astype(np.float32))


FA_CASES = [
    # (b, s, t, h, kv, d, causal, dtype, tol): the reference's FA_CASES ...
    (1, 128, 128, 4, 2, 64, True, jnp.float32, 2e-4),
    (2, 256, 256, 4, 4, 32, True, jnp.float32, 2e-4),
    (1, 128, 128, 2, 1, 128, False, jnp.float32, 2e-4),
    (1, 128, 128, 4, 2, 64, True, jnp.bfloat16, 3e-2),
    # ... plus a ragged length and a non-causal T != S
    (1, 100, 100, 4, 2, 32, True, jnp.float32, 2e-4),
    (1, 100, 100, 4, 2, 32, True, jnp.bfloat16, 3e-2),
    (1, 64, 128, 4, 2, 32, False, jnp.float32, 2e-4),
]


@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_plain_matches_jax(case):
    b, s, tk, h, kv, d, causal, dtype, tol = case
    q, k, v = _qkv(s + tk + d, (b, s, h, d), (b, tk, kv, d))
    want = jj(jax_flash_ref, *(jnp.asarray(x, dtype) for x in (q, k, v)),
              causal=causal)
    tq, tk_, tv = (t(x, TORCH_DT[dtype]) for x in (q, k, v))
    got = ref.flash_attention_ref(tq, tk_, tv, causal)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    # the entry point takes the plain version for CPU tensors
    assert torch.equal(ops.flash_attention(tq, tk_, tv, causal), got)


def test_flash_attention_grads_match_jax():
    """ops.flash_attention's backward (the plain chunked attention, as the
    reference's ``_fa_bwd``) against jax.grad of the reference."""
    q, k, v = _qkv(1, (1, 64, 4, 32), (1, 64, 2, 32))
    w = np.random.default_rng(2).standard_normal((1, 64, 4, 32)).astype(np.float32)
    f = lambda q, k, v: (jax_flash_ref(q, k, v, causal=True) * w).sum()
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    ts = [t(x).requires_grad_(True) for x in (q, k, v)]
    (ops.flash_attention(*ts, True) * t(w)).sum().backward()
    for got, ref_g in zip(ts, want):
        assert max_abs(got.grad, ref_g) < 1e-4


ATT_CASES = [
    # (lead, s, t, h, kv, d, causal, q_offset, chunk)
    ((), 24, 24, 4, 2, 16, True, 0, 8),
    ((2,), 24, 40, 4, 1, 16, True, 16, 16),
    ((2,), 24, 37, 2, 2, 8, False, 0, 16),     # ragged chunks
    ((), 9, 9, 6, 3, 8, True, 0, 4),
]


@pytest.mark.parametrize("case", ATT_CASES)
def test_attention_functions_match_jax(case):
    lead, s, tk, h, kv, d, causal, q_offset, chunk = case
    q, k, v = _qkv(s * tk, (*lead, s, h, d), (*lead, tk, kv, d))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk_, tv = map(t, (q, k, v))
    kw = dict(causal=causal, q_offset=q_offset)
    want = jj(jatt.attention_reference, jq, jk, jv, **kw)
    assert max_abs(tatt.attention_reference(tq, tk_, tv, **kw), want) < 1e-5
    want = jj(jatt.attention_chunked, jq, jk, jv, chunk_size=chunk, **kw)
    got = tatt.attention_chunked(tq, tk_, tv, chunk_size=chunk, **kw)
    assert max_abs(got, want) < 1e-5
    for impl in ("reference", "chunked"):
        got = tatt.attention(tq, tk_, tv, impl=impl, chunk_size=chunk, **kw)
        assert max_abs(got, want) < 1e-5


def test_attention_bias_and_masks_match_jax():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(4, (2, 12, 4, 8), (2, 20, 2, 8))
    bias = rng.standard_normal((4, 12, 20)).astype(np.float32)
    bias_t = rng.standard_normal((4, 12, 1)).astype(np.float32)
    key_mask = rng.random(20) > 0.3
    full_mask = rng.random((2, 1, 12, 20)) > 0.2
    jx, tx = list(map(jnp.asarray, (q, k, v))), list(map(t, (q, k, v)))
    for kw_j, kw_t in (
            (dict(bias=jnp.asarray(bias)), dict(bias=t(bias))),
            (dict(bias=jnp.asarray(bias_t)), dict(bias=t(bias_t))),
            (dict(mask=jnp.asarray(key_mask)),
             dict(mask=torch.as_tensor(key_mask))),
            (dict(mask=jnp.asarray(full_mask)),
             dict(mask=torch.as_tensor(full_mask)))):
        want = jj(jatt.attention_chunked, *jx, chunk_size=8, **kw_j)
        got = tatt.attention_chunked(*tx, chunk_size=8, **kw_t)
        assert max_abs(got, want) < 1e-5
        if "bias" in kw_j and kw_j["bias"].shape[-1] == 1:
            continue
        want = jj(jatt.attention_reference, *jx, **kw_j)
        assert max_abs(tatt.attention_reference(*tx, **kw_t), want) < 1e-5
    with pytest.raises(ValueError, match="trailing dim"):
        tatt.attention_chunked(*tx, bias=torch.zeros((4, 12, 7)))


def test_decode_attention_and_rope_match_jax():
    q1, kc, vc = _qkv(5, (3, 1, 4, 16), (3, 12, 2, 16))
    lengths = np.array([5, 12, 1], np.int32)
    want = jj(jatt.decode_attention, *map(jnp.asarray, (q1, kc, vc)),
              lengths=jnp.asarray(lengths))
    got = tatt.decode_attention(*map(t, (q1, kc, vc)),
                                lengths=torch.as_tensor(lengths))
    assert max_abs(got, want) < 1e-5
    x = np.random.default_rng(6).standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [9, 10, 11, 40, 41, 42, 1000]],
                   np.int32)
    for theta in (10000.0, 500.0):
        # eager: under jit XLA's fused sin/cos of angles up to 1000 rad
        # differ from libm's by ~1e-4 (fp32's spacing there is 6e-5)
        want = jax_rope(jnp.asarray(x), jnp.asarray(pos), theta=theta)
        got = apply_rope(t(x), torch.as_tensor(pos), theta=theta)
        assert max_abs(got, want) < 1e-5
    want = jax_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos))
    got = apply_rope(t(x, torch.bfloat16), torch.as_tensor(pos))
    assert got.dtype == torch.bfloat16
    assert max_abs(got, want) <= 2.0 ** -7 * np.abs(x).max()


def test_pallas_dispatch_raises_where_jax_raises():
    """tests/test_attention.py:131-145, for the port's dispatcher."""
    q = torch.zeros((2, 32, 2, 16))
    bias = torch.zeros((2, 32, 32))
    with pytest.raises(ValueError, match="mask"):
        tatt.attention(q, q, q, impl="pallas", mask=torch.ones(32, dtype=bool))
    with pytest.raises(ValueError, match="causal"):
        tatt.attention(q, q, q, impl="pallas", bias=bias, causal=True)
    with pytest.raises(ValueError, match="q_offset"):
        tatt.attention(q, q, q, impl="pallas", causal=True, q_offset=4)
    with pytest.raises(ValueError, match="broadcastable"):
        tatt.attention(q, q, q, impl="pallas", bias=torch.zeros((1, 1, 32)))
    with pytest.raises(ValueError, match="self-attention"):
        tatt.attention(q, q[:, :, :1], q[:, :, :1], impl="pallas", bias=bias)
    with pytest.raises(TypeError, match="unsupported"):
        tatt.attention(q, q, q, impl="pallas", dropout=0.1)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tatt.attention(q, q, q, impl="flash")


def test_pallas_dispatch_default_is_noncausal():
    q, k, v = _qkv(8, (1, 32, 2, 16), (1, 32, 2, 16))
    want = jj(jatt.attention_reference, *map(jnp.asarray, (q, k, v)),
              causal=False)
    assert max_abs(tatt.attention(*map(t, (q, k, v)), impl="pallas"), want) < 1e-5


def test_pallas_biased_attention_and_its_bias_gradient_match_jax():
    """The biased branch (K1 without its gate, plain on the CPU) against
    JAX attention_reference(bias=...), value and gradient in the bias."""
    L, s, h, d = 2, 32, 2, 16
    q, k, v = _qkv(9, (L, s, h, d), (L, s, h, d))
    bias = np.random.default_rng(10).standard_normal((h, s, s)).astype(np.float32)
    jx = list(map(jnp.asarray, (q, k, v)))
    want = jj(jatt.attention_reference, *jx, bias=jnp.asarray(bias))
    want_g = jax.jit(jax.grad(
        lambda b: jatt.attention_reference(*jx, bias=b).sum()))(jnp.asarray(bias))
    tb = t(bias).requires_grad_(True)
    got = tatt.attention(*map(t, (q, k, v)), impl="pallas", bias=tb)
    assert max_abs(got, want) < 2e-5
    got.sum().backward()
    assert max_abs(tb.grad, want_g) < 1e-4
    # without a gradient: the same plain forward through the entry point
    with torch.no_grad():
        again = ops.evo_attention_nogate(*map(t, (q, k, v)), t(bias))
    assert max_abs(again, want) < 2e-5
