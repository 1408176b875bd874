"""The rounding of the attention kernels' bf16 paths, on the CPU.

K6 (``csrc/flash_attention_fwd.cu``) walks the keys in tiles of 64 with an
online softmax in base 2: the running max m is taken over the raw scores s
and p = 2^(s * c - m * c), c = scale * log2(e); p is rounded to bf16 for P.V
against the running max of the tiles seen so far (not the row's max, as
the plain version rounds it), the row sum adds the unrounded fp32 p, and O
is rescaled by 2^((m_old - m_new) * c) when the max moves.  K2
(``csrc/evo_attention_bwd.cu``) computes p = exp2(s * scale * log2(e) +
bias * log2(e) - lse * log2(e)) instead of exp(s * scale + bias - lse).
K1 (``csrc/evo_attention_fwd.cu``, bf16) walks each lead row's keys in
tiles of 64 through its ring: the running max m is over the raw logits v
(v = q.k without a bias, v = q.k * scale + bias with one), p = 2^(v * c1 -
m * c1) with c1 = scale * log2(e) or log2(e), p rounded to bf16 for P.V
against the running max, the row sum over the fp32 p, and the
log-sum-exp m * scale + log(sum) (m + log(sum) with a bias).
These tests repeat that arithmetic in plain torch on the inputs
``chip_smoke.py`` draws and hold it to the tolerances the card checks use
against ``kernels.ref``: K6 |emulated - plain| <= 2e-3 + 2^-7 |plain|
(``K6_ATOL``, ``RTOL``), K1 <= 3e-2 + 2^-7 |plain| (``ATOL``, ``RTOL``) and
its log-sum-exp ``check_grad_close``, K2 ``check_grad_close`` with its
one-ulp term.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

import torch_threads  # noqa: F401  (one intra-op thread)

BF16 = torch.bfloat16
LOG2E = 1.4426950408889634


def _t(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(BF16)


def flash_tiles(q, k, v, causal, tile=64):
    """K6's bf16 arithmetic: tiles of keys, running max in base 2, p rounded
    to bf16 against the running max."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    c = np.float32(d ** -0.5 * LOG2E)
    qg = q.float().reshape(b, s, kv, h // kv, d)
    x = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    if causal:
        keep = torch.arange(s)[:, None] >= torch.arange(t)[None, :]
        x = x.masked_fill(~keep, float("-inf"))
    m = torch.full(x.shape[:-1], -1e30)
    lsum = torch.zeros(x.shape[:-1])
    o = torch.zeros(x.shape[:-1] + (d,))
    for k0 in range(0, t, tile):
        xt = x[..., k0:k0 + tile]        # raw scores: the max is taken on them
        mx = torch.maximum(m, xt.amax(-1))
        corr = torch.exp2((m - mx) * c)
        p = torch.exp2(xt * c - (mx * c)[..., None])
        lsum = lsum * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(BF16).float(), v[:, k0:k0 + tile].float())
        m = mx
    out = o / lsum.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(BF16)


def k6_excess(got, want):
    d = (got.float() - want.float()).abs()
    return (d - 2e-3 - 2.0 ** -7 * want.float().abs()).max().item()


@pytest.mark.parametrize("B,S,T,H,KV,D,causal", [
    (1, 300, 300, 4, 2, 128, True),    # the serving layout, ragged tiles
    (2, 200, 150, 4, 2, 128, True),    # T != S
    (1, 100, 333, 2, 1, 64, False),
])
def test_flash_tiles_stay_inside_the_card_tolerance(B, S, T, H, KV, D, causal):
    rng = np.random.default_rng(S + T + D)
    q, k, v = _t(rng, (B, S, H, D)), _t(rng, (B, T, KV, D)), _t(rng, (B, T, KV, D))
    want = ref.flash_attention_ref(q, k, v, causal)
    got = flash_tiles(q, k, v, causal)
    assert not torch.equal(got, want)      # the roundings do differ
    assert k6_excess(got, want) <= 0.0


def evo_bwd_exp2(q, k, v, bias, gate, out, lse, do):
    """``ref.evo_attention_bwd_ref`` with K2's base-2 p."""
    L, S, H, C = q.shape
    scale = C ** -0.5
    qf, kf, vf, dof, outf = (t.float() for t in (q, k, v, do, out))
    sig = torch.sigmoid(gate.float())
    do_raw = (dof * sig).to(BF16).float()
    delta = (dof * outf).sum(-1).permute(0, 2, 1)[..., None]
    x = (torch.einsum("lshc,lthc->lhst", qf, kf) * np.float32(scale * LOG2E)
         + bias.float()[None] * np.float32(LOG2E))
    p = torch.exp2(x - lse.reshape(L, H, S, 1) * np.float32(LOG2E))
    dp = torch.einsum("lshc,lthc->lhst", do_raw, vf)
    ds = p * (dp - delta)
    rnd = lambda t: t.to(BF16).float()
    dq = torch.einsum("lhst,lthc->lshc", rnd(ds), kf) * scale
    dk = torch.einsum("lhst,lshc->lthc", rnd(ds), qf) * scale
    dv = torch.einsum("lhst,lshc->lthc", rnd(p), do_raw)
    return dq.to(BF16), dk.to(BF16), dv.to(BF16), ds.sum(0)


def grad_excess(got, want):
    """How far |got - want| lies past chip_smoke.py's check_grad_close
    (with its one-ulp term for bf16 outputs)."""
    g, w = got.float(), want.float()
    lowp = want.dtype == BF16
    rtol = 2.0 ** -7 if lowp else 1e-5
    atol = 1e-4 * max(1.0, w.abs().max().item())
    extra = 2.0 ** -7 * max(1.0, w.abs().max().item()) if lowp else 0.0
    return ((g - w).abs() - atol - rtol * w.abs() - extra).max().item()


@pytest.mark.parametrize("L,S,H,C", [(8, 64, 2, 32), (4, 37, 2, 8)])
def test_evo_bwd_base2_p_stays_inside_the_card_tolerance(L, S, H, C):
    rng = np.random.default_rng(L * S + C)
    q, k, v, gate, do = (_t(rng, (L, S, H, C)) for _ in range(5))
    bias = _t(rng, (H, S, S))
    out, lse = ref.evo_attention_ref(q, k, v, bias, gate, return_lse=True)
    want = ref.evo_attention_bwd_ref(q, k, v, bias, gate, out, lse, do)
    got = evo_bwd_exp2(q, k, v, bias, gate, out, lse, do)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert grad_excess(a, b) <= 0.0, name
    assert math.isfinite(got[3].abs().max().item())


def evo_ring(q, k, v, bias, gate, tile=64):
    """K1's bf16 arithmetic: 64-key tiles of one lead row at a time, the
    running max over the raw logits, base-2 p rounded to bf16 against it.
    Returns (out, lse (L*H, S))."""
    L, S, H, C = q.shape
    scale = np.float32(C ** -0.5)
    x = torch.einsum("lshc,lthc->lhst", q.float(), k.float())
    if bias is not None:
        x = x * scale + bias.float()[None]
        c1, u1 = np.float32(LOG2E), np.float32(1.0)
    else:
        c1, u1 = np.float32(scale * LOG2E), scale
    m = torch.full(x.shape[:-1], -1e30)
    lsum = torch.zeros(x.shape[:-1])
    o = torch.zeros(x.shape[:-1] + (C,))
    for k0 in range(0, S, tile):
        xt = x[..., k0:k0 + tile]
        mx = torch.maximum(m, xt.amax(-1))
        corr = torch.exp2((m - mx) * c1)
        p = torch.exp2(xt * c1 - (mx * c1)[..., None])
        lsum = lsum * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum(
            "lhst,lthc->lhsc", p.to(BF16).float(), v[:, k0:k0 + tile].float())
        m = mx
    out = o / lsum.clamp_min(1e-30)[..., None]
    if gate is not None:
        out = out * torch.sigmoid(gate.float().permute(0, 2, 1, 3))
    lse = m * u1 + torch.log(lsum.clamp_min(1e-30))
    return out.permute(0, 2, 1, 3).to(BF16), lse.reshape(L * H, S)


@pytest.mark.parametrize("L,S,H,C,bias_dtype,masked", [
    (4, 256, 2, 32, torch.float32, True),   # a serving shape: the mask in the bias
    (4, 256, 2, 32, BF16, False),           # training: a bf16 pair bias
    (4, 128, 2, 32, None, False),           # training's MSA columns: no bias
    (3, 300, 1, 32, BF16, False),           # past S 256: bias tiles ride the ring
    (8, 100, 2, 8, torch.float32, True),    # extra MSA width, ragged tiles
    (3, 37, 2, 4, torch.float32, True),     # af2_tiny extra width
])
def test_evo_ring_stays_inside_the_card_tolerance(L, S, H, C, bias_dtype,
                                                  masked):
    rng = np.random.default_rng(L * S + C)
    q, k, v, gate = (_t(rng, (L, S, H, C)) for _ in range(4))
    bias = None
    if bias_dtype is not None:
        bias = torch.from_numpy(rng.standard_normal((H, S, S)).astype(
            np.float32)).to(bias_dtype)
        if masked:
            bias[:, :, S - S // 5:] = -1e9
    want, lse_r = ref.evo_attention_ref(q, k, v, bias, gate, return_lse=True)
    got, lse = evo_ring(q, k, v, bias, gate)
    if S > 64:                  # past one tile the roundings do differ
        assert not torch.equal(got, want)
    d = (got.float() - want.float()).abs()
    assert (d - 3e-2 - 2.0 ** -7 * want.float().abs()).max().item() <= 0.0
    assert grad_excess(lse, lse_r) <= 0.0
