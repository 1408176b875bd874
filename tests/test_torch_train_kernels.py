"""The port's backward paths on the CPU: the plain backward functions of the
kernels K2/K4/K5 and the autograd Functions that wrap them, against
``jax.vjp`` of the JAX references and against torch autograd through the
plain forwards; and AF2's shared-axis dropout.

Tolerances: attention gradients 1e-3 (``tests/test_kernels.py``), triangle
gradients 1e-4 (``tests/test_triangle.py``), both absolute on O(1) values;
Function against autograd 1e-5 (the same fp32 arithmetic in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import evoformer as jevo
from repro.kernels import ref as jref
from repro.nn.attention import attention_reference

from repro_torch.core import evoformer as tevo
from repro_torch.core.config import af2_tiny, with_kernels
from repro_torch.core.model import cycle_rng
from repro_torch.kernels import ops, ref

from torch_util import load_into, max_abs

ATT_TOL, TRI_TOL, FN_TOL = 1e-3, 1e-4, 1e-5


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("L,S,H,C,biased,gated", [
    (2, 16, 2, 8, True, True),
    (3, 13, 2, 4, True, True),      # ragged length, head dim 4
    (2, 13, 2, 8, False, True),     # no bias (MSA column attention)
    (2, 13, 2, 8, True, False),     # no gate
])
def test_evo_attention_bwd_ref_matches_jax_vjp(L, S, H, C, biased, gated):
    rng = np.random.default_rng(S * 10 + C)
    q, k, v, g, do = (_np(rng, L, S, H, C) for _ in range(5))
    bias = _np(rng, H, S, S) if biased else None

    def jfn(q, k, v, bias, g):
        if g is None:
            return attention_reference(q, k, v, bias=bias)
        if bias is None:
            o = attention_reference(q, k, v)
            return jax.nn.sigmoid(g) * o
        return jref.evo_attention_ref(q, k, v, bias, g)

    jargs = [jnp.asarray(a) if a is not None else None
             for a in (q, k, v, bias, g if gated else None)]

    def fwd_bwd(args, cot):
        out, vjp = jax.vjp(lambda *a: jfn(*a), *args)
        return out, vjp(cot)

    # one compile of the forward and its vjp (op by op, JAX compiles each op)
    out_j, want = jax.jit(fwd_bwd)(jargs, jnp.asarray(do))

    t = lambda a: None if a is None else torch.from_numpy(a)
    tq, tk, tv, tb, tg = t(q), t(k), t(v), t(bias), t(g if gated else None)
    out, lse = ref.evo_attention_ref(tq, tk, tv, tb, tg, return_lse=True)
    assert max_abs(out, out_j) < ATT_TOL
    dq, dk, dv, dbias, dgate = ref.evo_attention_bwd_ref(
        tq, tk, tv, tb, tg, out, lse, t(do))
    for got, w in ((dq, want[0]), (dk, want[1]), (dv, want[2]),
                   (dbias, want[3]), (dgate, want[4])):
        if w is None:
            assert got is None
        else:
            assert max_abs(got, w) < ATT_TOL


@pytest.mark.parametrize("outgoing", [True, False])
@pytest.mark.parametrize("r", [16, 13])
def test_triangle_mult_bwd_matches_jax_vjp(outgoing, r):
    """tri_mult_apply through the kernels' Function (K3 forward with s, K4
    and K5 backward: their plain versions here) against jax.vjp of the JAX
    fp32-accumulating reference, for z and every parameter."""
    cfg = with_kernels(af2_tiny()).evoformer
    jp = jevo.triangle_mult_init(jax.random.PRNGKey(r), cfg.c_z,
                                 cfg.c_hidden_mul)
    rng = np.random.default_rng(r + outgoing)
    jp = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.3 * _np(rng, *np.shape(x)), jp)
    z, dy = _np(rng, r, r, cfg.c_z), _np(rng, r, r, cfg.c_z)

    def fwd_bwd(zz, pp, cot):
        out, vjp = jax.vjp(
            lambda zz, pp: jevo.triangle_mult(pp, zz, outgoing=outgoing),
            zz, pp)
        return out, vjp(cot)

    # one compile of the forward and its vjp (op by op, JAX compiles each op)
    out_j, (dz_j, dp_j) = jax.jit(fwd_bwd)(jnp.asarray(z), jp,
                                           jnp.asarray(dy))

    mod = load_into(tevo.TriangleMult(cfg.c_z, cfg.c_hidden_mul,
                                      generator=torch.Generator()), jp,
                    stacked=())
    tz = torch.from_numpy(z).requires_grad_(True)
    out = tevo.tri_mult_apply(mod, cfg, tz, outgoing=outgoing)
    assert max_abs(out, out_j) < TRI_TOL
    (out * torch.from_numpy(dy)).sum().backward()
    assert max_abs(tz.grad, dz_j) < TRI_TOL
    flat_j = dict(jax.tree_util.tree_flatten_with_path(dp_j)[0])
    for path, want in flat_j.items():
        key = ".".join(p.key for p in path)
        got = mod.get_parameter(key).grad
        assert max_abs(got, want) < TRI_TOL, key


def _grads(fn, tensors, cot):
    ts = [None if t is None else t.clone().requires_grad_(True)
          for t in tensors]
    (fn(*ts) * cot).sum().backward()
    return [None if t is None else t.grad for t in ts]


@pytest.mark.parametrize("biased", [True, False])
def test_evo_attention_function_matches_autograd(biased):
    rng = np.random.default_rng(3)
    L, S, H, C = 2, 11, 2, 8
    q, k, v, g, cot = (torch.from_numpy(_np(rng, L, S, H, C))
                       for _ in range(5))
    b = torch.from_numpy(_np(rng, H, S, S)) if biased else None
    if biased:
        got = _grads(ops.evo_attention, (q, k, v, b, g), cot)
    else:
        got = _grads(lambda q, k, v, b, g: ops.evo_attention_nobias(q, k, v, g),
                     (q, k, v, b, g), cot)
    want = _grads(lambda *a: ref.evo_attention_ref(*a), (q, k, v, b, g), cot)
    for a, w in zip(got, want):
        assert (a is None) == (w is None)
        if a is not None:
            assert max_abs(a, w) < FN_TOL


def test_triangle_mult_function_matches_autograd():
    rng = np.random.default_rng(4)
    r, c_z, c = 9, 16, 8
    x = torch.from_numpy(_np(rng, r, r, c_z))
    ws = [torch.from_numpy(_np(rng, *s, scale=0.5)) for s in (
        (c_z, 2 * c), (2 * c,), (c_z, 2 * c), (2 * c,), (c,), (c,),
        (c, c_z), (c_z,), (c_z, c_z), (c_z,))]
    cot = torch.from_numpy(_np(rng, r, r, c_z))
    for xab in (lambda t: t, lambda t: t.transpose(0, 1)):
        fn = lambda x, *w: ops.triangle_mult(xab(x), xab(x), x, *w)
        plain = lambda x, *w: ref.triangle_mult_ref(xab(x), xab(x), x, *w)
        for a, w in zip(_grads(fn, (x, *ws), cot),
                        _grads(plain, (x, *ws), cot)):
            assert max_abs(a, w) < FN_TOL


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------

def test_shared_dropout_rate_scale_and_shared_axis():
    x = torch.ones((64, 96, 4))
    for axis in (0, 1):
        y = tevo.shared_dropout(x, 0.25, shared_axis=axis, rng=(1, 2),
                                deterministic=False)
        kept = y != 0
        # one draw per row (axis 0 shared) or per column (axis 1 shared)
        assert bool((kept == kept.select(axis, 0).unsqueeze(axis)).all())
        assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
        # 384 or 256 independent draws: keep-rate 0.75 within 5 sigma
        n = x.numel() // x.shape[axis]
        assert abs(kept.float().mean().item() - 0.75) < 5 * (0.1875 / n) ** 0.5
    same = tevo.shared_dropout(x, 0.25, shared_axis=0, rng=(1, 2),
                               deterministic=False)
    assert torch.equal(same, tevo.shared_dropout(x, 0.25, shared_axis=0,
                                                 rng=(1, 2),
                                                 deterministic=False))
    assert torch.equal(tevo.shared_dropout(x, 0.25, shared_axis=0,
                                           rng=(1, 2), deterministic=True), x)


def test_dropout_masks_differ_across_cycles_and_steps():
    x = torch.ones((32, 64, 2))
    mask = lambda rng: (tevo.shared_dropout(x, 0.25, shared_axis=0, rng=rng,
                                            deterministic=False) != 0)
    step0, step1 = (0, 0, 0), (0, 1, 0)     # (seed, step, sample)
    masks = [mask(cycle_rng(step0, 0)), mask(cycle_rng(step0, 1)),
             mask(cycle_rng(step1, 0))]
    for i in range(3):
        for j in range(i + 1, 3):
            agree = (masks[i] == masks[j]).float().mean().item()
            assert agree < 0.8      # independent masks agree ~62.5%


def _key(*words):
    """A training step's dropout key: device lanes of (seed, step)."""
    return tevo.dropout_key(words, "cpu")


@pytest.mark.parametrize("rate", [0.15, 0.25])
def test_hash_dropout_key_is_shared_scaled_and_keeps_one_minus_rate(rate):
    """The Key form: one keep/drop per row or column, kept entries scaled
    by 1 / (1 - rate), a keep rate within 5 binomial sigmas of 1 - rate,
    and the same words and path give the same mask."""
    x = torch.ones((64, 96, 4))
    key = tevo.fold_in(tevo.fold_in(_key(3, 7), 0), 2)  # protein 0, cycle 2
    for axis in (0, 1):
        y = tevo.shared_dropout(x, rate, shared_axis=axis, rng=key,
                                deterministic=False)
        kept = y != 0
        assert bool((kept == kept.select(axis, 0).unsqueeze(axis)).all())
        assert torch.allclose(y[kept], torch.full_like(y[kept],
                                                       1 / (1 - rate)))
        n = x.numel() // x.shape[axis]
        p = 1 - rate
        assert abs(kept.float().mean().item() - p) < 5 * (p * rate / n) ** 0.5
        again = tevo.Key(_key(3, 7).lanes, (0, 2))
        assert torch.equal(y, tevo.shared_dropout(
            x, rate, shared_axis=axis, rng=again, deterministic=False))
    big = torch.ones((1, 200_000))
    kept = tevo.shared_dropout(big, rate, shared_axis=0, rng=key,
                               deterministic=False) != 0
    p = 1 - rate
    assert abs(kept.float().mean().item() - p) < 5 * (p * rate / big.numel()) ** 0.5
    # neighbouring elements are independent: both kept with probability p^2
    both = (kept[0, 1:] & kept[0, :-1]).float().mean().item()
    assert abs(both - p * p) < 5 * (p * p * (1 - p * p) / big.numel()) ** 0.5


def test_hash_dropout_masks_differ_across_cycles_steps_and_proteins():
    x = torch.ones((32, 64, 2))
    mask = lambda rng: (tevo.shared_dropout(x, 0.25, shared_axis=0, rng=rng,
                                            deterministic=False) != 0)
    protein = lambda step, b: tevo.fold_in(_key(0, step), b)
    masks = [mask(cycle_rng(protein(0, 0), 0)), mask(cycle_rng(protein(0, 0), 1)),
             mask(cycle_rng(protein(1, 0), 0)), mask(cycle_rng(protein(0, 1), 0))]
    for i in range(len(masks)):
        for j in range(i + 1, len(masks)):
            agree = (masks[i] == masks[j]).float().mean().item()
            assert agree < 0.8      # independent masks agree ~62.5%

