"""The rounding of the attention kernels' bf16 paths, on the CPU.

K6 (``csrc/flash_attention_fwd.cu``) walks the keys in tiles of 64 with an
online softmax in base 2: the running max m is taken over the raw scores s
and p = 2^(s * c - m * c), c = scale * log2(e); p is rounded to bf16 for P.V
against the running max of the tiles seen so far (not the row's max, as
the plain version rounds it), the row sum adds the unrounded fp32 p, and O
is rescaled by 2^((m_old - m_new) * c) when the max moves.  K2
(``csrc/evo_attention_bwd.cu``) computes p = exp2(s * scale * log2(e) +
bias * log2(e) - lse * log2(e)) instead of exp(s * scale + bias - lse).
These tests repeat that arithmetic in plain torch on the inputs
``chip_smoke.py`` draws and hold it to the tolerances the card checks use
against ``kernels.ref``: K6 |emulated - plain| <= 2e-3 + 2^-7 |plain|
(``K6_ATOL``, ``RTOL``), K2 ``check_grad_close`` with its one-ulp term.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

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
