"""Plain PyTorch versions of the port's two kernels.

Each repeats its kernel's arithmetic in eager torch: the CPU path of
``kernels.ops`` runs them, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  They are not a yardstick of speed.
"""
from __future__ import annotations

from typing import Optional

import torch

LN_EPS = 1e-5


def evo_attention_ref(q, k, v, bias: Optional[torch.Tensor],
                      gate: Optional[torch.Tensor],
                      scale: Optional[float] = None) -> torch.Tensor:
    """Gated bias attention (kernel K1).

    q/k/v/gate (L, S, H, C) with pre-sigmoid gate logits; bias (H, S, S),
    shared across the L rows.  Either of bias and gate may be None.
    Scores and softmax statistics are fp32; for bf16 inputs the unnormalised
    probabilities are rounded to bf16 before the product with v (the
    kernel's tensor-core path, and the Pallas kernel's ``p.astype(v.dtype)``),
    and the sum they are divided by stays fp32.  Returns (L, S, H, C) in q's
    dtype.
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
    return o.to(q.dtype)


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
                      w_g, b_g, k_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Fused triangle-multiplicative update (kernel K3).

    xa (r_i, r_k, c_z) / xb (r_j, r_k, c_z): gated-projection sources with
    the contracted axis k on axis 1; xg (r_i, r_j, c_z): gate source in
    output orientation; w_a/w_b packed [value | gate] (c_z, 2c).  The gated
    projections are rounded to the input dtype (the kernel stages them in
    device memory in that dtype); the contraction, its LayerNorm (eps 1e-5)
    and the epilogue accumulate in fp32, and for bf16 inputs LN(s) is rounded
    to bf16 before the out-projection (the kernel's tensor-core operand).
    Returns (r_i, r_j, c_z) in xg's dtype.
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
    return (g * u).to(xg.dtype)
