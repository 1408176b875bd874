"""The precision argument of K5's bf16 tensor-core path, on the CPU.

K5 (``csrc/triangle_mult_bwd.cu``) keeps every fp32 operand of the
reference's arithmetic (ds, the streamed side's gated projection str, dh)
as a pair of bf16 values, hi = bf16(v) and lo = bf16(v - hi), and forms each
product from bf16 products accumulated in fp32: hi*hi' + hi*lo' + lo*hi'
for two fp32 operands, hi*w + lo*w for an fp32 operand against a bf16 one.
These tests repeat that arithmetic in plain torch (a product of two bf16
values is exact in fp32) and hold it to the tolerance ``chip_smoke.py``'s
``check_grad_close`` holds the kernel to on the card, against the fp32
plain version ``kernels.ref.triangle_mult_bwd_dx_ref``:

    |split - plain| <= 1e-4 * max(1, max|plain|) + rtol * |plain|,

rtol 2^-7 for the bf16 dx, 1e-5 for the fp32 dW and db.  A single bf16
rounding of ds does not stay inside it: the split is what the tolerance
needs.

K4 (the LayerNorm + out-projection + gate backward, same file) does the
same for its fp32 operands n = LN(s), du and dzg: u = n.W_o, dn = du.W_o^T
and dx_g = dzg.W_g^T take two products each, dW_o = n^T du three, dW_g =
x_g^T dzg two, zg = x_g.W_g one (both bf16).  Its tests hold that
arithmetic to the same tolerance against
``kernels.ref.triangle_mult_bwd_epilogue_ref``, and show that one bf16
rounding of any of n, du or dzg instead leaves it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

import torch_threads  # noqa: F401  (one intra-op thread)

BF16 = torch.bfloat16


def split(v):
    """(hi, lo) bf16 values of an fp32 tensor, returned as fp32."""
    hi = v.to(BF16).float()
    return hi, (v - hi).to(BF16).float()


def bwd_dx_split(ds, x_loc, x_str, w_loc, b_loc, w_str, b_str, *,
                 single_ds=False):
    """K5's function with the kernel's split products; ``single_ds`` rounds
    ds to one bf16 instead (its lo part dropped)."""
    c, cz = w_loc.shape[1] // 2, x_loc.shape[-1]
    d_hi, d_lo = split(ds.float())
    if single_ds:
        d_lo = torch.zeros_like(d_lo)
    s_hi, s_lo = split(ref.gated_projection(x_str, w_str, b_str))
    eq = "pqc,qkc->pkc"
    dloc = (torch.einsum(eq, d_hi, s_hi) + torch.einsum(eq, d_hi, s_lo)
            + torch.einsum(eq, d_lo, s_hi))
    h = x_loc.float() @ w_loc.float() + b_loc.float()
    val, sg = h[..., :c], torch.sigmoid(h[..., c:])
    dh = torch.cat([dloc * sg, dloc * val * sg * (1.0 - sg)], -1)
    h_hi, h_lo = split(dh)
    w = w_loc.float()
    dx = (h_hi @ w.T + h_lo @ w.T).to(x_loc.dtype)
    xf = x_loc.float().reshape(-1, cz)
    dw = xf.T @ h_hi.reshape(-1, 2 * c) + xf.T @ h_lo.reshape(-1, 2 * c)
    return dx, dw, dh.reshape(-1, 2 * c).sum(0)


def excess(got, want):
    """How far |got - want| lies past check_grad_close's tolerance (<= 0:
    inside it)."""
    g, w = got.float(), want.float()
    rtol = 2.0 ** -7 if got.dtype == BF16 else 1e-5
    atol = 1e-4 * max(1.0, w.abs().max().item())
    return ((g - w).abs() - atol - rtol * w.abs()).max().item()


def inputs(r, cz, c, seed):
    """x, the packed weights and ds as chip_smoke.py draws them: ds is the
    plain K4's output on the plain K3's s of the same x."""
    rng = np.random.default_rng(seed)
    t = lambda shape, scale=1.0: torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32)).to(BF16)
    x = t((r, r, cz))
    w_a, b_a = t((cz, 2 * c), cz ** -0.5), t((2 * c,), 0.5)
    w_b, b_b = t((cz, 2 * c), cz ** -0.5), t((2 * c,), 0.5)
    ln_s, ln_b = (1.0 + t((c,), 0.1).float()).to(BF16), t((c,), 0.1)
    w_o, b_o = t((c, cz), c ** -0.5), t((cz,), 0.1)
    w_g, b_g = t((cz, cz), cz ** -0.5), t((cz,), 0.5)
    xab = x.transpose(0, 1)                 # incoming: transposed operands
    _, s = ref.triangle_mult_ref(xab, xab, x, w_a, b_a, w_b, b_b, ln_s, ln_b,
                                 w_o, b_o, w_g, b_g, return_s=True)
    ds = ref.triangle_mult_bwd_epilogue_ref(s, x, t((r, r, cz)), ln_s, ln_b,
                                            w_o, b_o, w_g, b_g)[0]
    return xab, (w_a, b_a, w_b, b_b), ds


def sides(xab, w, ds):
    w_a, b_a, w_b, b_b = w
    return ((ds, xab, xab, w_a, b_a, w_b, b_b),
            (ds.transpose(0, 1), xab, xab, w_b, b_b, w_a, b_a))


@pytest.mark.parametrize("r,cz,c", [(16, 16, 16),      # af2_tiny
                                    (64, 128, 128)])   # af2_initial widths
def test_split_products_stay_inside_the_card_tolerance(r, cz, c):
    xab, w, ds = inputs(r, cz, c, seed=r + c)
    for args in sides(xab, w, ds):
        want = ref.triangle_mult_bwd_dx_ref(*args)
        got = bwd_dx_split(*args)
        for name, a, b in zip(("dx", "dw", "db"), got, want):
            assert excess(a, b) <= 0.0, name


def test_single_bf16_ds_leaves_the_card_tolerance():
    xab, w, ds = inputs(64, 128, 128, seed=7)
    args = sides(xab, w, ds)[0]
    want = ref.triangle_mult_bwd_dx_ref(*args)
    got = bwd_dx_split(*args, single_ds=True)
    assert max(excess(a, b) for a, b in zip(got, want)) > 0.0


LN_EPS = 1e-5


def bwd_epilogue_split(s, xg, dy, ln_s, ln_b, w_o, b_o, w_g, b_g, *,
                       single=None):
    """K4's function with the kernel's split products; ``single`` names one
    of "n", "du", "dzg" to round to one bf16 instead (its lo part
    dropped).  The vector sums add the fp32 values, as the kernel does."""
    c, cz = s.shape[-1], xg.shape[-1]

    def sp(v, name):
        hi, lo = split(v)
        return (hi, torch.zeros_like(lo)) if name == single else (hi, lo)

    gam = ln_s.float()
    mu = s.mean(-1, keepdim=True)
    rstd = torch.rsqrt((s - mu).square().mean(-1, keepdim=True) + LN_EPS)
    nhat = (s - mu) * rstd
    n_hi, n_lo = sp(nhat * gam + ln_b.float(), "n")
    wo, wg = w_o.float(), w_g.float()
    u = n_hi @ wo + n_lo @ wo + b_o.float()
    xgf = xg.float()
    g = torch.sigmoid(xgf @ wg + b_g.float())
    du = dy.float() * g
    dzg = dy.float() * u * g * (1.0 - g)
    du_hi, du_lo = sp(du, "du")
    dz_hi, dz_lo = sp(dzg, "dzg")
    dn = du_hi @ wo.T + du_lo @ wo.T
    dxg = (dz_hi @ wg.T + dz_lo @ wg.T).to(xg.dtype)
    dnh = dn * gam
    ds = rstd * (dnh - dnh.mean(-1, keepdim=True)
                 - nhat * (dnh * nhat).mean(-1, keepdim=True))
    f = lambda t, d: t.reshape(-1, d)
    n_h, n_l, d_h, d_l = f(n_hi, c), f(n_lo, c), f(du_hi, cz), f(du_lo, cz)
    dw_o = n_h.T @ d_h + n_h.T @ d_l + n_l.T @ d_h
    dw_g = f(xgf, cz).T @ f(dz_hi, cz) + f(xgf, cz).T @ f(dz_lo, cz)
    return (ds, dxg, f(dn * nhat, c).sum(0), f(dn, c).sum(0), dw_o,
            f(du, cz).sum(0), dw_g, f(dzg, cz).sum(0))


def epilogue_inputs(r, cz, c, seed):
    """s, x_g, dy and the parameters as chip_smoke.py draws them for K4."""
    rng = np.random.default_rng(seed)
    t = lambda shape, scale=1.0: torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32)).to(BF16)
    s = torch.from_numpy(rng.standard_normal((r, r, c)).astype(np.float32))
    return (s, t((r, r, cz)), t((r, r, cz)), (1.0 + t((c,), 0.1).float()).to(BF16),
            t((c,), 0.1), t((c, cz), c ** -0.5), t((cz,), 0.1),
            t((cz, cz), cz ** -0.5), t((cz,), 0.5))


EPI_OUTS = ("ds", "dxg", "dln_s", "dln_b", "dw_o", "db_o", "dw_g", "db_g")


@pytest.mark.parametrize("r,cz,c", [(16, 16, 16),      # af2_tiny
                                    (64, 128, 128)])   # af2_initial widths
def test_epilogue_split_products_stay_inside_the_card_tolerance(r, cz, c):
    args = epilogue_inputs(r, cz, c, seed=r + c)
    want = ref.triangle_mult_bwd_epilogue_ref(*args)
    got = bwd_epilogue_split(*args)
    for name, a, b in zip(EPI_OUTS, got, want):
        assert excess(a, b) <= 0.0, name


@pytest.mark.parametrize("single", ["n", "du", "dzg"])
def test_single_bf16_epilogue_operand_leaves_the_card_tolerance(single):
    args = epilogue_inputs(64, 128, 128, seed=11)
    want = ref.triangle_mult_bwd_epilogue_ref(*args)
    got = bwd_epilogue_split(*args, single=single)
    over = [n for n, a, b in zip(EPI_OUTS, got, want) if excess(a, b) > 0.0]
    assert over, f"one bf16 rounding of {single} stayed inside the tolerance"
