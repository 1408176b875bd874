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
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

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
