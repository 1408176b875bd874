"""The port's CUDA kernels against their plain versions, on the card.

Marker ``cuda``: every test here needs an NVIDIA GPU and skips without one
(the ``cuda_dev`` fixture decides at run time).  On the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py``.

Tolerance: |kernel - plain| <= atol + rtol * |plain| elementwise.  fp32:
atol 2e-4 (the reference's kernel tolerance, tests/test_kernels.py), rtol
1e-5.  bf16: atol 3e-2 (the reference's bf16 tolerance), rtol 2^-7 — the
kernel and its plain version do the same fp32 arithmetic in another order,
so a bf16 output (or a staged bf16 projection) may round one ulp apart.
K6 in bf16: atol 2e-3 — its outputs are means of up to 1000 N(0, 1) values
(|out| ~0.05, where 3e-2 would pass a dropped key tile); rtol covers one ulp
of the output, atol the rounding of p against a running max.

Backward kernels (K2, K4, K5) and the residuals (K1's log-sum-exp, K3's s):
|kernel - plain| <= 1e-4 * max(1, max|plain|) + rtol * |plain|, rtol 2^-7
for bf16 outputs (one ulp either side) and 1e-5 for fp32 ones.  Both sides
compute in fp32 from the same inputs, so they differ by summation order and
the final rounding; their sums run over up to r (or L) terms of O(1), so
the absolute part scales with the largest gradient.  K3's s in bf16: the
kernel stages the gated projections a, b in bf16 and the plain version
rounds its own fp32 projections, so an element may round one ulp apart;
each term a_k b_k may then move by 2^-7 |a_k b_k|, so s is held to
2^-7 sum_k |a_k| |b_k| on top of the fp32 tolerance.  K2's bf16 outputs:
the kernel rounds dS, P and do_raw to bf16 as the operands of its tensor-
core products (as the Pallas kernel's dots do) and the plain version
rounds the same values, computed in fp32 in another order, so a few terms
may round one ulp apart: they are held to one bf16 ulp (2^-7) of the
output's largest value on top.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cost as kcost
from repro_torch.kernels import evo_attention as ka
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import triangle as kt

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (2e-4, 1e-5), torch.bfloat16: (3e-2, 2.0 ** -7)}
K6_TOL = {**TOL, torch.bfloat16: (2e-3, 2.0 ** -7)}


def _assert_close(got, want, dtype, tol=TOL):
    atol, rtol = tol[dtype]
    d = (got.float() - want.float()).abs()
    excess = (d - atol - rtol * want.float().abs()).max().item()
    assert excess <= 0.0, f"max |diff| {d.max().item()} over tolerance"


def _assert_grad_close(got, want, what="", extra=0.0):
    if want is None:
        assert got is None, what
        return
    g, w = got.float(), want.float()
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert bool(torch.isfinite(g).all()), what
    rtol = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-5
    atol = 1e-4 * max(1.0, w.abs().max().item())
    excess = ((g - w).abs() - atol - rtol * w.abs() - extra).max().item()
    assert excess <= 0.0, (f"{what}: max |diff| {(g - w).abs().max().item()}"
                           f" max |want| {w.abs().max().item()}")


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, shape, dtype, dev, scale=1.0):
    return torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,S,H,C,biased,gated", [
    (3, 37, 2, 4, True, True),     # ragged S, af2_tiny extra width
    (2, 100, 4, 8, True, False),   # ragged S, extra-stack width
    (2, 130, 3, 16, False, True),  # two query tiles, no bias
    (4, 256, 4, 32, True, True),   # triangle attention width
])
def test_evo_attention_kernel_matches_plain(cuda_dev, dtype, L, S, H, C,
                                            biased, gated):
    rng = np.random.default_rng(L * 1000 + S)
    q, k, v, g = (_t(rng, (L, S, H, C), dtype, cuda_dev) for _ in range(4))
    bias = _t(rng, (H, S, S), torch.float32, cuda_dev) if biased else None
    if biased:
        bias[:, :, S // 2:] = -1e9      # masked keys, as mask_bias folds them
    gate = g if gated else None
    got = ka.evo_attention_fwd(q, k, v, bias, gate)
    want = ref.evo_attention_ref(q, k, v, bias, gate)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)


def test_evo_attention_kernel_bf16_bias(cuda_dev):
    rng = np.random.default_rng(5)
    q, k, v, g = (_t(rng, (2, 64, 2, 8), torch.bfloat16, cuda_dev)
                  for _ in range(4))
    bias = _t(rng, (2, 64, 64), torch.bfloat16, cuda_dev)
    got = ka.evo_attention_fwd(q, k, v, bias, g)
    want = ref.evo_attention_ref(q, k, v, bias, g)
    _assert_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("L,S,H,C,bias_dtype,gated", [
    # lead rows not a multiple of a block's chunk (19 a block on 132 SMs)
    (301, 256, 4, 32, torch.float32, True),
    (600, 256, 8, 8, torch.bfloat16, True),   # C 8 (m16n8k8), L >= 512
    (2, 1000, 1, 32, torch.float32, True),    # S past the resident bias tile
    (2, 1000, 1, 32, torch.bfloat16, False),
    (3, 999, 2, 16, torch.float32, True),     # ... with unaligned bias rows
    (4, 256, 4, 32, torch.float32, False),    # an fp32 bias on bf16 inputs
    (33, 128, 8, 32, None, True),             # no bias: raw-score maxima
])
def test_evo_attention_ring_edges(cuda_dev, L, S, H, C, bias_dtype, gated):
    """K1's bf16 ring kernel at the edges of its design: lead-row chunks,
    C 8, the bias tile riding the ring past S 256, an fp32 bias; its output
    and log-sum-exp against the plain version, and the same bits twice."""
    rng = np.random.default_rng(L + S + C)
    q, k, v, g = (_t(rng, (L, S, H, C), torch.bfloat16, cuda_dev)
                  for _ in range(4))
    bias = None
    if bias_dtype is not None:
        bias = _t(rng, (H, S, S), bias_dtype, cuda_dev)
        bias[:, :, S - S // 5:] = -1e9     # masked keys
    gate = g if gated else None
    out, lse = ka.evo_attention_fwd(q, k, v, bias, gate, return_lse=True)
    want, lse_r = ref.evo_attention_ref(q, k, v, bias, gate, return_lse=True)
    again = ka.evo_attention_fwd(q, k, v, bias, gate)
    torch.cuda.synchronize()
    _assert_close(out, want, torch.bfloat16)
    _assert_grad_close(lse, lse_r, "lse")
    assert torch.equal(out, again)


def _tri_args(rng, r, c_z, c, dtype, dev):
    xa = _t(rng, (r, r, c_z), dtype, dev)
    w = lambda *s: _t(rng, s, dtype, dev, scale=s[0] ** -0.5)
    bvec = lambda n: _t(rng, (n,), dtype, dev, scale=0.5)
    return (xa, w(c_z, 2 * c), bvec(2 * c), w(c_z, 2 * c), bvec(2 * c),
            1.0 + bvec(c), bvec(c), w(c, c_z), bvec(c_z), w(c_z, c_z),
            bvec(c_z))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c_z,c,outgoing,masked", [
    (16, 16, 16, True, False),     # af2_tiny widths
    (37, 16, 16, False, True),     # ragged r, incoming, masked
    (100, 128, 128, True, True),   # ragged r at af2_initial width
    (130, 128, 128, False, True),  # r past two 64-row tiles, masked
])
def test_triangle_kernel_matches_plain(cuda_dev, dtype, r, c_z, c, outgoing,
                                       masked):
    rng = np.random.default_rng(r + c)
    x, *w = _tri_args(rng, r, c_z, c, dtype, cuda_dev)
    xab = x if outgoing else x.transpose(0, 1)
    km = None
    if masked:
        km = torch.ones(r, device=cuda_dev)
        km[r - r // 4:] = 0.0
    got = kt.triangle_mult_fwd(xab, xab, x, *w, k_mask=km)
    want = ref.triangle_mult_ref(xab, xab, x, *w, k_mask=km)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)


def test_kernel_launch_counters(cuda_dev):
    rng = np.random.default_rng(0)
    q = _t(rng, (1, 8, 1, 4), torch.float32, cuda_dev)
    before = ka.launches
    ka.evo_attention_fwd(q, q, q, None, None)
    assert ka.launches == before + 1
    x, *w = _tri_args(rng, 8, 16, 16, torch.float32, cuda_dev)
    before = kt.launches
    kt.triangle_mult_fwd(x, x, x, *w)
    assert kt.launches == before + 1
    s = torch.zeros((8, 8, 16), device=cuda_dev)
    before = (kt.epi_launches, kt.dx_launches)
    ds = kt.triangle_mult_bwd_epilogue(s, x, x, *w[4:])[0]
    kt.triangle_mult_bwd_dx(ds, x, x, *w[:4])
    assert (kt.epi_launches, kt.dx_launches) == (before[0] + 1, before[1] + 1)


def test_kernel_rejects_bad_input(cuda_dev):
    q = torch.zeros((1, 8, 1, 12), device=cuda_dev)
    with pytest.raises(ValueError, match="head dim"):
        ka.evo_attention_fwd(q, q, q, None, None)
    q = torch.zeros((1, 8, 2, 8), device=cuda_dev)
    with pytest.raises(ValueError, match="contiguous"):
        ka.evo_attention_fwd(q, q.transpose(1, 2).contiguous().transpose(1, 2),
                             q, None, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,S,H,C,biased,gated", [
    (3, 37, 2, 4, True, True),     # ragged S, af2_tiny extra width
    (2, 100, 4, 8, True, False),   # ragged S, extra-stack width, no gate
    (2, 130, 3, 16, False, True),  # two query tiles, no bias
    (4, 256, 4, 32, True, True),   # triangle attention width, 4 dbias chunks
    (64, 64, 2, 32, True, True),   # one lead row per dbias chunk
    (3, 130, 2, 16, True, True),   # S past two 64-row tiles, ragged
    (2, 1, 2, 8, True, True),      # S 1: one valid row of one tile
    (2, 1000, 1, 32, True, True),  # long S with a bias (no buffer grows with S)
    (200, 256, 4, 32, True, True),  # lead rows walked in several groups a block
])
def test_evo_attention_bwd_kernel_matches_plain(cuda_dev, dtype, L, S, H, C,
                                                biased, gated):
    rng = np.random.default_rng(L * 1000 + S + 7)
    q, k, v, g, do = (_t(rng, (L, S, H, C), dtype, cuda_dev) for _ in range(5))
    bias = _t(rng, (H, S, S), dtype, cuda_dev) if biased else None
    gate = g if gated else None
    out, lse = ka.evo_attention_fwd(q, k, v, bias, gate, return_lse=True)
    out_r, lse_r = ref.evo_attention_ref(q, k, v, bias, gate, return_lse=True)
    torch.cuda.synchronize()
    _assert_close(out, out_r, dtype)
    _assert_grad_close(lse, lse_r, "lse")
    got = ka.evo_attention_bwd(q, k, v, bias, gate, out_r, lse_r, do)
    want = ref.evo_attention_bwd_ref(q, k, v, bias, gate, out_r, lse_r, do)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "dbias", "dgate"), got, want):
        lowp = b is not None and b.dtype == torch.bfloat16
        extra = 2.0 ** -7 * max(1.0, b.abs().max().item()) if lowp else 0.0
        _assert_grad_close(a, b, name, extra)
    again = ka.evo_attention_bwd(q, k, v, bias, gate, out_r, lse_r, do)
    for a, b in zip(got, again):       # no atomics: the same bits twice
        assert a is None or torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c_z,c", [
    (16, 16, 16),       # af2_tiny widths
    (37, 16, 16),       # ragged r
    (100, 128, 128),    # ragged r at af2_initial width
    (130, 128, 128),    # r past two 64-row tiles
])
def test_triangle_bwd_kernels_match_plain(cuda_dev, dtype, r, c_z, c):
    rng = np.random.default_rng(r + 3 * c)
    x, *w = _tri_args(rng, r, c_z, c, dtype, cuda_dev)
    xab = x.transpose(0, 1)            # incoming: transposed operand views
    y, s = kt.triangle_mult_fwd(xab, xab, x, *w, return_s=True)
    y_r, s_r = ref.triangle_mult_ref(xab, xab, x, *w, return_s=True)
    torch.cuda.synchronize()
    _assert_close(y, y_r, dtype)
    extra = 0.0
    if dtype == torch.bfloat16:     # staged bf16 projections, see the header
        a = ref.gated_projection(xab, w[0], w[1]).to(dtype).float().abs()
        b = ref.gated_projection(xab, w[2], w[3]).to(dtype).float().abs()
        extra = 2.0 ** -7 * torch.einsum("ikc,jkc->ijc", a, b)
    _assert_grad_close(s, s_r, "s", extra)
    dy = _t(rng, (r, r, c_z), dtype, cuda_dev)
    w_a, b_a, w_b, b_b, ln_s, ln_b, w_o, b_o, w_g, b_g = w
    got = kt.triangle_mult_bwd_epilogue(s_r, x, dy, ln_s, ln_b, w_o, b_o,
                                        w_g, b_g)
    want = ref.triangle_mult_bwd_epilogue_ref(s_r, x, dy, ln_s, ln_b, w_o,
                                              b_o, w_g, b_g)
    torch.cuda.synchronize()
    for name, a, b in zip(("ds", "dxg", "dln_s", "dln_b", "dw_o", "db_o",
                           "dw_g", "db_g"), got, want):
        _assert_grad_close(a, b, name)
    ds = want[0]
    for side, (dsv, xl, xs_, wl, bl, ws, bs) in enumerate((
            (ds, xab, xab, w_a, b_a, w_b, b_b),
            (ds.transpose(0, 1), xab, xab, w_b, b_b, w_a, b_a))):
        got = kt.triangle_mult_bwd_dx(dsv, xl, xs_, wl, bl, ws, bs)
        want = ref.triangle_mult_bwd_dx_ref(dsv, xl, xs_, wl, bl, ws, bs)
        torch.cuda.synchronize()
        for name, a, b in zip(("dx", "dw", "db"), got, want):
            _assert_grad_close(a, b, f"side {side} {name}")
        again = kt.triangle_mult_bwd_dx(dsv, xl, xs_, wl, bl, ws, bs)
        for a, b in zip(got, again):   # no atomics: the same bits twice
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launches_refuse_less_scratch_than_their_layout(cuda_dev, dtype,
                                                        monkeypatch):
    """The wrappers size K2-K5's scratch by kernels/cost.py; with one
    element (K4, K5) or byte (K2, K3) fewer, each launch refuses."""
    rng = np.random.default_rng(11)
    r, c_z, c = 37, 16, 16
    x, *w = _tri_args(rng, r, c_z, c, dtype, cuda_dev)
    s = _t(rng, (r, r, c), torch.float32, cuda_dev)
    L, S, H, C = 3, 37, 2, 8
    q, k, v, g, do = (_t(rng, (L, S, H, C), dtype, cuda_dev) for _ in range(5))
    bias = _t(rng, (H, S, S), dtype, cuda_dev)
    out, lse = ref.evo_attention_ref(q, k, v, bias, g, return_lse=True)
    calls = {
        "evo_attention_bwd_scratch": lambda: ka.evo_attention_bwd(
            q, k, v, bias, g, out, lse, do),
        "triangle_mult_fwd_scratch": lambda: kt.triangle_mult_fwd(
            x, x, x, *w),
        "triangle_mult_bwd_epilogue_scratch":
            lambda: kt.triangle_mult_bwd_epilogue(s, x, x, *w[4:]),
        "triangle_mult_bwd_dx_scratch": lambda: kt.triangle_mult_bwd_dx(
            s, x, x, *w[:4])}
    for name, call in calls.items():
        call()                              # the right size launches
        sized = getattr(kcost, name)
        with monkeypatch.context() as m:
            m.setattr(kcost, name, lambda *a, _f=sized, **kw: _f(*a, **kw) - 1)
            with pytest.raises(RuntimeError, match="launch failed"):
                call()
    torch.cuda.synchronize()


@pytest.mark.parametrize("r,c_z,c", [(256, 128, 128), (37, 16, 16)])
def test_triangle_bwd_epilogue_reruns_bit_identical(cuda_dev, r, c_z, c):
    """No atomics in K4: ds, dx_g and every parameter gradient are the same
    bits on a second run (the pair pass's block partials and the split-K
    dW partials are added in a fixed order)."""
    rng = np.random.default_rng(r + c_z)
    x, *w = _tri_args(rng, r, c_z, c, torch.bfloat16, cuda_dev)
    _, _, _, _, ln_s, ln_b, w_o, b_o, w_g, b_g = w
    s = _t(rng, (r, r, c), torch.float32, cuda_dev)
    dy = _t(rng, (r, r, c_z), torch.bfloat16, cuda_dev)
    args = (s, x, dy, ln_s, ln_b, w_o, b_o, w_g, b_g)
    first = kt.triangle_mult_bwd_epilogue(*args)
    second = kt.triangle_mult_bwd_epilogue(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("ds", "dxg", "dln_s", "dln_b", "dw_o", "db_o",
                           "dw_g", "db_g"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("L,S,H,C", [
    (256, 256, 4, 32),   # triangle attention shape: dbias from 17 partials
    (48, 100, 8, 8),     # ragged S, bias rows copied to 16-byte pitch
])
def test_evo_attention_bwd_kernel_reruns_bit_identical(cuda_dev, L, S, H, C):
    """No atomics in K2: dq, dk, dv, dbias and dgate are the same bits on a
    second run."""
    rng = np.random.default_rng(S + C)
    q, k, v, g, do = (_t(rng, (L, S, H, C), torch.bfloat16, cuda_dev)
                      for _ in range(5))
    bias = _t(rng, (H, S, S), torch.bfloat16, cuda_dev)
    out, lse = ka.evo_attention_fwd(q, k, v, bias, g, return_lse=True)
    first = ka.evo_attention_bwd(q, k, v, bias, g, out, lse, do)
    second = ka.evo_attention_bwd(q, k, v, bias, g, out, lse, do)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "dbias", "dgate"), first, second):
        assert torch.equal(a, b), name


def test_autograd_functions_on_the_card(cuda_dev):
    """ops' autograd Functions on CUDA tensors (K1+K2, K3+K4+K5) against
    autograd through the plain forwards on the same tensors."""
    rng = np.random.default_rng(11)
    L, S, H, C = 3, 48, 2, 8
    base = [_t(rng, (L, S, H, C), torch.float32, cuda_dev) for _ in range(4)]
    base.append(_t(rng, (H, S, S), torch.float32, cuda_dev))
    dout = _t(rng, (L, S, H, C), torch.float32, cuda_dev)

    def grads(fn):
        ts = [t.clone().requires_grad_(True) for t in base]
        q, k, v, g, b = ts
        (fn(q, k, v, b, g) * dout).sum().backward()
        return [t.grad for t in ts]

    before = ops.launch_counts()
    got = grads(ops.evo_attention)
    after = ops.launch_counts()
    assert after["evo_attention_fwd"] == before["evo_attention_fwd"] + 1
    assert after["evo_attention_bwd"] == before["evo_attention_bwd"] + 1
    want = grads(lambda q, k, v, b, g: ref.evo_attention_ref(q, k, v, b, g))
    for a, b in zip(got, want):
        _assert_grad_close(a, b)

    r, c_z, c = 24, 16, 16
    x, *w = _tri_args(rng, r, c_z, c, torch.float32, cuda_dev)
    dy = _t(rng, (r, r, c_z), torch.float32, cuda_dev)

    def tri_grads(fn):
        ts = [t.clone().requires_grad_(True) for t in (x, *w)]
        xx, *ww = ts
        (fn(xx, xx, xx, *ww) * dy).sum().backward()
        return [t.grad for t in ts]
    got = tri_grads(ops.triangle_mult)
    want = tri_grads(ref.triangle_mult_ref)
    for a, b in zip(got, want):
        _assert_grad_close(a, b)


def test_masked_triangle_mult_stays_forward_only_on_the_card(cuda_dev):
    x = torch.zeros((4, 4, 16), device=cuda_dev, requires_grad=True)
    w = [torch.zeros(s, device=cuda_dev) for s in (
        (16, 32), (32,), (16, 32), (32,), (16,), (16,), (16, 16), (16,),
        (16, 16), (16,))]
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.triangle_mult_masked(x, x, x, torch.ones(4, device=cuda_dev), *w)


# ---------------------------------------------------------------------------
# K6: the LM's grouped-query flash attention forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,KV,D,causal", [
    (1, 128, 128, 4, 2, 64, True),      # the reference's FA_CASES
    (2, 256, 256, 4, 4, 32, True),
    (1, 128, 128, 2, 1, 128, False),
    (1, 100, 100, 4, 2, 64, True),      # ragged tiles
    (2, 77, 77, 6, 3, 32, False),
    (1, 64, 128, 4, 2, 64, False),      # T != S
    (1, 130, 70, 4, 1, 128, True),      # T < S: rows past T see every key
    (1, 1000, 1000, 32, 2, 128, True),  # glm4-9b width, ragged
    (2, 200, 150, 4, 2, 128, True),     # D 128 tiles (128 queries, 64 keys):
    (2, 129, 129, 4, 1, 128, True),     # ragged S and T, T != S, batch 2
    (2, 70, 333, 4, 2, 128, False),
    (1, 1, 1, 2, 1, 128, True),
    (1, 500, 500, 32, 32, 112, True),   # zamba2-7b's shared attention
    (2, 77, 77, 4, 2, 112, False),      # D 112: ragged tiles, GQA,
    (1, 130, 70, 4, 4, 112, True),      # T < S
])
def test_flash_attention_kernel_matches_plain(cuda_dev, dtype, B, S, T, H,
                                              KV, D, causal):
    rng = np.random.default_rng(B * S + T + H + D)
    q = _t(rng, (B, S, H, D), dtype, cuda_dev)
    k = _t(rng, (B, T, KV, D), dtype, cuda_dev)
    v = _t(rng, (B, T, KV, D), dtype, cuda_dev)
    got = kf.flash_attention_fwd(q, k, v, causal)
    want = ref.flash_attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert got.shape == (B, S, H, D) and got.dtype == dtype
    _assert_close(got, want, dtype, K6_TOL)


def test_flash_attention_kernel_reads_strided_views(cuda_dev):
    """q/k/v as views of the fused projections (B, S, heads, D) with a
    position stride larger than heads * D, as a packed QKV layout gives."""
    rng = np.random.default_rng(5)
    B, S, H, KV, D = 2, 96, 4, 2, 64
    qkv = _t(rng, (B, S, H + 2 * KV, D), torch.bfloat16, cuda_dev)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    got = kf.flash_attention_fwd(q, k, v, True)
    want = ref.flash_attention_ref(q.contiguous(), k.contiguous(),
                                   v.contiguous(), True)
    _assert_close(got, want, torch.bfloat16, K6_TOL)


def test_flash_attention_launch_counter_and_checks(cuda_dev):
    q = torch.zeros((1, 16, 2, 32), device=cuda_dev)
    before = kf.launches
    ops.flash_attention(q, q, q, True)
    assert kf.launches == before + 1
    with pytest.raises(ValueError, match="head dim"):
        kf.flash_attention_fwd(torch.zeros((1, 8, 2, 48), device=cuda_dev),
                               torch.zeros((1, 8, 2, 48), device=cuda_dev),
                               torch.zeros((1, 8, 2, 48), device=cuda_dev))
    with pytest.raises(ValueError, match="kv heads"):
        kf.flash_attention_fwd(torch.zeros((1, 8, 3, 32), device=cuda_dev),
                               torch.zeros((1, 8, 2, 32), device=cuda_dev),
                               torch.zeros((1, 8, 2, 32), device=cuda_dev))
    assert kf.launches == before + 1


def test_flash_attention_autograd_on_the_card(cuda_dev):
    """ops.flash_attention with a gradient: K6 forward, the reference's
    backward (autograd through the plain chunked attention)."""
    from repro_torch.nn.attention import attention_reference
    rng = np.random.default_rng(12)
    base = [_t(rng, (1, 80, 4, 32), torch.float32, cuda_dev)] + [
        _t(rng, (1, 80, 2, 32), torch.float32, cuda_dev) for _ in range(2)]
    dout = _t(rng, (1, 80, 4, 32), torch.float32, cuda_dev)

    def grads(fn):
        ts = [t.clone().requires_grad_(True) for t in base]
        (fn(*ts) * dout).sum().backward()
        return [t.grad for t in ts]

    before = kf.launches
    got = grads(lambda q, k, v: ops.flash_attention(q, k, v, True))
    assert kf.launches == before + 1
    want = grads(lambda q, k, v: attention_reference(q, k, v, causal=True))
    for a, b in zip(got, want):
        _assert_grad_close(a, b)


def test_flash_attention_on_two_cards_in_one_process(cuda_dev):
    """K6's 230,456-byte shared-memory attribute belongs to each device's
    context: one process launches it on cuda:0, then on cuda:1."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    rng = np.random.default_rng(21)
    for index in (0, 1, 0):
        dev = torch.device("cuda", index)
        q = _t(rng, (1, 256, 4, 128), torch.bfloat16, dev)
        k = _t(rng, (1, 256, 2, 128), torch.bfloat16, dev)
        v = _t(rng, (1, 256, 2, 128), torch.bfloat16, dev)
        got = kf.flash_attention_fwd(q, k, v, True)
        want = ref.flash_attention_ref(q, k, v, True)
        torch.cuda.synchronize(dev)
        assert got.device == dev
        _assert_close(got, want, torch.bfloat16, K6_TOL)
