"""The Evoformer impls that the configs run by default, and the naive OPM,
against the JAX package's own functions: ``gated_attention`` at
``attention_impl="chunked"``, ``tri_mult_apply`` at
``tri_mult_impl="chunked"`` (through ``triangle_mult_fused``), and
``outer_product_mean`` (``opm_impl="naive"``), on the same numpy inputs
and the same randomized parameters (the port's init plus N(0, 0.02) numpy
noise, carried across by ``repro_torch.bridge``).

Each function's oracle is one jit (``torch_util.fast_jit``) that holds
both policies: the reference at fp32, its bf16 cast, and the fp32
gradients by ``jax.vjp`` of a fixed numpy cotangent.  The shapes are
ragged against the chunks: S 13 and r 10 over chunks of 4.

Tolerances: fp32 forward 2e-4 and bf16 3e-2 of the output's scale (at
least 1), the triangle update 1e-5, gradients 1e-4 of each leaf's scale
(at least 1).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import evoformer as jevo
from repro.core.config import EvoformerConfig as JaxEvoformerConfig
from repro.nn import layers as jnn

from repro_torch import bridge
from repro_torch.core import evoformer as tevo
from repro_torch.core.config import EvoformerConfig
from repro_torch.nn.layers import Policy

from torch_util import fast_jit, load_into, randomize_np, to_np

L, S, C, C_Z, HEADS, C_HID = 3, 13, 16, 8, 2, 8
R, C_MUL, CHUNK = 10, 6, 4
F32_TOL, BF16_TOL, TRI_TOL, GRAD_TOL = 2e-4, 3e-2, 1e-5, 1e-4


def _params(module) -> dict:
    return randomize_np(bridge.state_dict_to_params(module.state_dict(),
                                                    stacked=()), 7)


def _both_policies(fn):
    """``fn(params, *xs, *extra)`` at fp32, at the bf16 cast of params and
    inputs (``extra``, the masks, as they are), and the fp32 vjp of ``cot``
    with respect to params and ``xs``: one jit."""
    def run(params, xs, extra, cot):
        out, vjp = jax.vjp(lambda p, *a: fn(p, *a, *extra), params, *xs)
        bf = jnn.Policy(compute_dtype=jnp.bfloat16).cast
        out16 = fn(bf(params), *(x.astype(jnp.bfloat16) for x in xs), *extra)
        return out, out16, vjp(cot)
    return fast_jit(run)


def _close(got, want, tol):
    got, want = to_np(got), to_np(want)
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale, \
        (np.abs(got - want).max(), tol * scale)


def _mask(m):
    return None if m is None else torch.from_numpy(m)


def _port(module, params, fn, xs, extra, cot):
    """The port's fp32 output and gradients (the params' by key path, then
    each of ``xs``') and its bf16 output."""
    load_into(module, params, stacked=())
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    masks = [_mask(m) for m in extra]
    out = fn(module, *ts, *masks)
    out.backward(torch.from_numpy(cot))
    grads = {k: p.grad for k, p in module.named_parameters()}
    with torch.no_grad():
        out16 = fn(Policy(compute_dtype=torch.bfloat16).cast(module),
                   *(t.detach().to(torch.bfloat16) for t in ts), *masks)
    assert out16.dtype == torch.bfloat16
    return out, out16, grads, [t.grad for t in ts]


def _check(got, want, tol):
    out, out16, grads, xgrads = got
    want_out, want16, (want_p, *want_x) = want
    _close(out, want_out, tol)
    _close(out16, want16, BF16_TOL)
    flat = bridge.flatten(want_p)
    assert set(grads) == set(flat)
    for k, g in grads.items():
        _close(g, flat[k], GRAD_TOL)
    assert len(xgrads) == len(want_x)
    for g, w in zip(xgrads, want_x):
        _close(g, w, GRAD_TOL)


# ---------------------------------------------------------------------------
# gated attention, chunked
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _attention_oracle():
    def fn(p, x, z, km):
        return jevo.gated_attention(p, x, n_head=HEADS, c_hidden=C_HID,
                                    bias_input=z, key_mask=km,
                                    attention_impl="chunked",
                                    attention_chunk=CHUNK)
    return _both_policies(fn)


def test_chunked_gated_attention_matches_jax():
    """Pair-biased gated attention over a ragged S 13 in key chunks of 4,
    three keys masked."""
    module = tevo.GatedAttention(C, C_HID, HEADS, c_bias_in=C_Z,
                                 generator=torch.Generator().manual_seed(0))
    params = _params(module)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((L, S, C)).astype(np.float32)
    z = rng.standard_normal((S, S, C_Z)).astype(np.float32)
    km = np.ones((S,), np.float32)
    km[-3:] = 0.0
    cot = rng.standard_normal((L, S, C)).astype(np.float32)
    want = _attention_oracle()(params, (x, z), (km,), cot)

    def fn(p, x, z, km):
        return tevo.gated_attention(p, x, n_head=HEADS, c_hidden=C_HID,
                                    bias_input=z, key_mask=km,
                                    attention_impl="chunked",
                                    attention_chunk=CHUNK)
    _check(_port(module, params, fn, (x, z), (km,), cot), want, F32_TOL)


# ---------------------------------------------------------------------------
# triangle multiplicative update, chunked
# ---------------------------------------------------------------------------

TRI_CFG = dict(c_z=C_Z, c_hidden_mul=C_MUL, tri_mult_impl="chunked",
               tri_mult_chunk=CHUNK)


@functools.lru_cache(maxsize=None)
def _triangle_oracle(outgoing: bool):
    cfg = JaxEvoformerConfig(**TRI_CFG)

    def fn(p, z, km):
        return jevo.tri_mult_apply(p, cfg, z, outgoing=outgoing, k_mask=km)
    return _both_policies(fn)


@pytest.mark.parametrize("outgoing", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_triangle_mult_matches_jax(outgoing, masked):
    """``tri_mult_apply`` at ``tri_mult_impl="chunked"``: ragged r 10 in
    i-slabs and k-chunks of 4 (the last k-chunk padded and masked), with
    and without a k mask (two padded residues)."""
    module = tevo.TriangleMult(C_Z, C_MUL,
                               generator=torch.Generator().manual_seed(2))
    params = _params(module)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((R, R, C_Z)).astype(np.float32)
    km = None
    if masked:
        km = np.ones((R,), np.float32)
        km[-2:] = 0.0
    cot = rng.standard_normal((R, R, C_Z)).astype(np.float32)
    want = _triangle_oracle(outgoing)(params, (z,), (km,), cot)
    cfg = EvoformerConfig(**TRI_CFG)
    got = _port(module, params, lambda p, z, km: tevo.tri_mult_apply(
        p, cfg, z, outgoing=outgoing, k_mask=km), (z,), (km,), cot)
    _check(got, want, TRI_TOL)


def test_chunked_triangle_mult_masks_padded_k_without_a_mask():
    """The chunk padding alone (no ``k_mask``): the padded k columns,
    whose gated projection is not zero, contribute nothing, so the result
    equals the same update at a chunk that divides r."""
    module = tevo.TriangleMult(C_Z, C_MUL,
                               generator=torch.Generator().manual_seed(2))
    load_into(module, _params(module), stacked=())
    z = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (R, R, C_Z)).astype(np.float32))
    with torch.no_grad():
        outs = [tevo.tri_mult_apply(module, EvoformerConfig(
            **{**TRI_CFG, "tri_mult_chunk": c}), z, outgoing=True)
            for c in (CHUNK, 5)]
    _close(outs[0], outs[1], TRI_TOL)


# ---------------------------------------------------------------------------
# outer product mean, naive
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _opm_oracle():
    return _both_policies(lambda p, msa, rows: jevo.outer_product_mean(
        p, msa, row_mask=rows))


def test_naive_outer_product_mean_matches_jax():
    """``outer_product_mean`` with a row mask (two padded MSA rows): the
    mean over the valid rows; ``opm_apply`` routes ``opm_impl="naive"``
    to it."""
    n_seq, c_m, c_opm = 7, 12, 4
    module = tevo.OuterProductMean(c_m, c_opm, C_Z,
                                   generator=torch.Generator().manual_seed(5))
    params = _params(module)
    rng = np.random.default_rng(6)
    msa = rng.standard_normal((n_seq, R, c_m)).astype(np.float32)
    rows = np.ones((n_seq,), np.float32)
    rows[-2:] = 0.0
    cot = rng.standard_normal((R, R, C_Z)).astype(np.float32)
    want = _opm_oracle()(params, (msa,), (rows,), cot)
    got = _port(module, params, lambda p, m, r: tevo.outer_product_mean(
        p, m, row_mask=r), (msa,), (rows,), cot)
    _check(got, want, F32_TOL)
    cfg = EvoformerConfig(c_m=c_m, c_hidden_opm=c_opm, c_z=C_Z,
                          opm_impl="naive")
    with torch.no_grad():
        routed = tevo.opm_apply(module, cfg, torch.from_numpy(msa),
                                row_mask=torch.from_numpy(rows))
    assert torch.equal(routed, got[0].detach())
    with pytest.raises(ValueError, match="unknown opm impl"):
        tevo.opm_apply(module, dataclasses.replace(cfg, opm_impl="dense"),
                       torch.from_numpy(msa))
