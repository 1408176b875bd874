"""Plain PyTorch versions of the port's kernels: the forwards K1 and K3
(each optionally returning its backward residual), the backwards K2, K4
and K5, and the LM flash-attention forward K6.

Each repeats its kernel's arithmetic in eager torch: the CPU path of
``kernels.ops`` runs them, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  They are not a yardstick of speed.  The
backwards compute in fp32 from their (fp32 or bf16) inputs, as the Pallas
backward kernels do, and round only their outputs.
"""
from __future__ import annotations

from typing import Optional

import torch

LN_EPS = 1e-5


def evo_attention_ref(q, k, v, bias: Optional[torch.Tensor],
                      gate: Optional[torch.Tensor],
                      scale: Optional[float] = None, *,
                      return_lse: bool = False):
    """Gated bias attention (kernel K1).

    q/k/v/gate (L, S, H, C) with pre-sigmoid gate logits; bias (H, S, S),
    shared across the L rows.  Either of bias and gate may be None.
    Scores and softmax statistics are fp32; for bf16 inputs the unnormalised
    probabilities are rounded to bf16 before the product with v (the
    kernel's tensor-core path, and the Pallas kernel's ``p.astype(v.dtype)``),
    and the sum they are divided by stays fp32.  Returns (L, S, H, C) in q's
    dtype; with ``return_lse`` also the fp32 log-sum-exp of each score row,
    (L*H, S), the backward's residual.
    """
    c = q.shape[-1]
    scale = c ** -0.5 if scale is None else scale
    logits = torch.einsum("lshc,lthc->lhst", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()[None]
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    denom = e.sum(-1, keepdim=True)
    if q.dtype != torch.float32:
        e = e.to(q.dtype).float()
    o = torch.einsum("lhst,lthc->lshc", e / denom, v.float())
    if gate is not None:
        o = o * torch.sigmoid(gate.float())
    o = o.to(q.dtype).contiguous()     # the kernels' layout, for K2 to read
    if not return_lse:
        return o
    lse = logits.amax(-1) + torch.log(denom[..., 0])
    return o, lse.reshape(-1, lse.shape[-1])


def evo_attention_bwd_ref(q, k, v, bias, gate, out, lse, do,
                          scale: Optional[float] = None):
    """Flash backward of :func:`evo_attention_ref` (kernel K2) from the saved
    gated output ``out`` and the fp32 ``lse`` (L*H, S):

        dgate = do * out * (1 - sigmoid(gate)),   do_raw = do * sigmoid(gate)
        p = exp(s - lse),  delta = rowsum(do * out),  ds = p * (do_raw.v - delta)
        dq = ds.k * scale, dk = ds^T.q * scale, dv = p^T.do_raw, dbias = sum_L ds

    For bf16 inputs the products take bf16 operands, as the kernel's tensor
    cores do (and the Pallas kernel's dots): do_raw is rounded to bf16 for
    dp and dv, ds for dq and dk, p for dv; sums and dbias stay fp32.
    Returns (dq, dk, dv, dbias, dgate): dq/dk/dv in q's dtype, dgate in
    gate's, dbias (H, S, S) fp32; dbias / dgate are None without bias / gate.
    """
    L, S, H, C = q.shape
    scale = C ** -0.5 if scale is None else scale
    qf, kf, vf = q.float(), k.float(), v.float()
    dof, outf = do.float(), out.float()
    dgate = None
    do_raw = dof
    if gate is not None:
        sig = torch.sigmoid(gate.float())
        dgate = (dof * outf * (1.0 - sig)).to(gate.dtype)
        do_raw = dof * sig
    delta = (dof * outf).sum(-1).permute(0, 2, 1)[..., None]      # (L, H, S, 1)
    logits = torch.einsum("lshc,lthc->lhst", qf, kf) * scale
    if bias is not None:
        logits = logits + bias.float()[None]
    p = torch.exp(logits - lse.reshape(L, H, S, 1))
    rnd = ((lambda t: t.to(q.dtype).float()) if q.dtype != torch.float32
           else (lambda t: t))
    do_raw = rnd(do_raw)
    dp = torch.einsum("lshc,lthc->lhst", do_raw, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("lhst,lthc->lshc", rnd(ds), kf) * scale
    dk = torch.einsum("lhst,lshc->lthc", rnd(ds), qf) * scale
    dv = torch.einsum("lhst,lshc->lthc", rnd(p), do_raw)
    dbias = ds.sum(0) if bias is not None else None
    # contiguous (L, S, H, C), the layout K2 writes
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous(), dbias, dgate)


def flash_attention_ref(q, k, v, causal: bool = True,
                        scale: Optional[float] = None):
    """Grouped-query attention (kernel K6): q (B, S, H, D), k/v (B, T, KV, D)
    with H = KV * G; query head h reads kv head h // G.  ``causal``: query i
    sees keys 0..i (both positions from 0, also when T != S).  Scores and the
    softmax are fp32; for bf16 inputs the unnormalised probabilities are
    rounded to bf16 before the product with v (the kernel's tensor-core
    operand, the Pallas kernel's ``p.astype(v.dtype)``) and divided by the
    fp32 row sum afterwards.  Returns (B, S, H, D) in q's dtype."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qg = q.float().reshape(b, s, kv, h // kv, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if causal:
        keep = torch.arange(s, device=q.device)[:, None] >= torch.arange(
            t, device=q.device)[None, :]
        logits = logits.masked_fill(~keep, float("-inf"))
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    denom = e.sum(-1, keepdim=True)
    if v.dtype != torch.float32:
        e = e.to(v.dtype).float()
    o = torch.einsum("bkgst,btkd->bskgd", e / denom, v.float())
    return o.reshape(b, s, h, d).to(q.dtype)


def gated_projection(x, w, b, k_mask: Optional[torch.Tensor] = None):
    """sigmoid(x·W_gate + b_gate) ⊙ (x·W_val + b_val), fp32, from packed
    [value | gate] weights; ``k_mask`` (r_k,) scales axis 1 of x's rows."""
    c = w.shape[1] // 2
    h = x.float() @ w.float() + b.float()
    a = torch.sigmoid(h[..., c:]) * h[..., :c]
    if k_mask is not None:
        a = a * k_mask.float()[None, :, None]
    return a


def triangle_mult_ref(xa, xb, xg, w_a, b_a, w_b, b_b, ln_s, ln_b, w_o, b_o,
                      w_g, b_g, k_mask: Optional[torch.Tensor] = None, *,
                      return_s: bool = False):
    """Fused triangle-multiplicative update (kernel K3).

    xa (r_i, r_k, c_z) / xb (r_j, r_k, c_z): gated-projection sources with
    the contracted axis k on axis 1; xg (r_i, r_j, c_z): gate source in
    output orientation; w_a/w_b packed [value | gate] (c_z, 2c).  The gated
    projections are rounded to the input dtype (the kernel stages them in
    device memory in that dtype); the contraction, its LayerNorm (eps 1e-5)
    and the epilogue accumulate in fp32, and for bf16 inputs LN(s) is rounded
    to bf16 before the out-projection (the kernel's tensor-core operand).
    Returns (r_i, r_j, c_z) in xg's dtype; with ``return_s`` also the fp32
    pre-LayerNorm contraction s (r_i, r_j, c), the backward's residual.
    """
    a = gated_projection(xa, w_a, b_a, k_mask).to(xa.dtype)
    b = gated_projection(xb, w_b, b_b).to(xb.dtype)
    s = torch.einsum("ikc,jkc->ijc", a.float(), b.float())
    mu = s.mean(-1, keepdim=True)
    var = (s - mu).square().mean(-1, keepdim=True)
    n = (s - mu) * torch.rsqrt(var + LN_EPS) * ln_s.float() + ln_b.float()
    if xg.dtype != torch.float32:
        n = n.to(xg.dtype).float()
    u = n @ w_o.float() + b_o.float()
    g = torch.sigmoid(xg.float() @ w_g.float() + b_g.float())
    y = (g * u).to(xg.dtype)
    return (y, s.contiguous()) if return_s else y


def triangle_mult_bwd_epilogue_ref(s, xg, dy, ln_s, ln_b, w_o, b_o, w_g,
                                   b_g):
    """LayerNorm + out-projection + gate backward from the saved fp32
    contraction ``s`` (kernel K4).  Returns (ds, dxg, dln_s, dln_b, dw_o,
    db_o, dw_g, db_g): ds and the parameter gradients fp32 (summed over
    every pair), dxg in xg's dtype."""
    c, cz = s.shape[-1], xg.shape[-1]
    gam = ln_s.float()
    mu = s.mean(-1, keepdim=True)
    var = (s - mu).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    nhat = (s - mu) * rstd
    n = nhat * gam + ln_b.float()
    u = n @ w_o.float() + b_o.float()
    xgf = xg.float()
    g = torch.sigmoid(xgf @ w_g.float() + b_g.float())
    dyf = dy.float()
    du = dyf * g
    dzg = dyf * u * g * (1.0 - g)
    dxg = (dzg @ w_g.float().T).to(xg.dtype)
    dn = du @ w_o.float().T
    dnh = dn * gam
    ds = rstd * (dnh - dnh.mean(-1, keepdim=True)
                 - nhat * (dnh * nhat).mean(-1, keepdim=True))
    flat = lambda t, d: t.reshape(-1, d)
    return (ds, dxg, flat(dn * nhat, c).sum(0), flat(dn, c).sum(0),
            flat(n, c).T @ flat(du, cz), flat(du, cz).sum(0),
            flat(xgf, cz).T @ flat(dzg, cz), flat(dzg, cz).sum(0))


def triangle_mult_bwd_dx_ref(ds, x_loc, x_str, w_loc, b_loc, w_str, b_str):
    """Contraction + gated-projection backward for one operand side (kernel
    K5): ``d_loc[p,k] = sum_q ds[p,q] * str[q,k]`` with ``str`` the streamed
    side's gated projection, pushed back through the local side's gated
    projection.  ``ds`` (r_p, r_q, c) has the local side's rows leading
    (pass ``ds.transpose(0, 1)`` for the other side).  Returns (dx_loc in
    x_loc's dtype, dw_loc fp32 (c_z, 2c), db_loc fp32 (2c,))."""
    c = w_loc.shape[1] // 2
    cz = x_loc.shape[-1]
    strv = gated_projection(x_str, w_str, b_str)                  # (q, k, c)
    dloc = torch.einsum("pqc,qkc->pkc", ds.float(), strv)
    h = x_loc.float() @ w_loc.float() + b_loc.float()
    val, sg = h[..., :c], torch.sigmoid(h[..., c:])
    dh = torch.cat([dloc * sg, dloc * val * sg * (1.0 - sg)], -1)
    dx = (dh @ w_loc.float().T).to(x_loc.dtype)
    dw = x_loc.float().reshape(-1, cz).T @ dh.reshape(-1, 2 * c)
    return dx, dw, dh.reshape(-1, 2 * c).sum(0)
