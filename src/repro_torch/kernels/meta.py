"""The kernels' meta route: what each CUDA wrapper returns and holds, for
tensors on the ``meta`` device (the dry run, ``launch/dryrun.py``).

Each function mirrors one wrapper of ``kernels/evo_attention.py``,
``kernels/triangle.py`` or ``kernels/flash_attention.py``: it allocates
on ``meta`` the same outputs (shapes and dtypes)
and the same temporaries (the scratch of ``kernels/cost.py``'s
``*_scratch`` functions, the transposed weight copies of the fp32 paths),
held until it returns, as the wrapper holds them until its launch returns.  So a trace
that counts live storages sees the kernel's memory.  Nothing is computed:
a meta tensor has no values.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cost

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _scratch(nbytes: int, device) -> torch.Tensor:
    return torch.empty((nbytes,), dtype=torch.uint8, device=device)


def evo_attention_fwd(q, k, v, bias: Optional[torch.Tensor],
                      gate: Optional[torch.Tensor],
                      scale: Optional[float] = None, *,
                      return_lse: bool = False):
    """K1: (L, S, H, C) in q's dtype; with ``return_lse`` also the fp32
    (L*H, S) log-sum-exps."""
    L, S, H, C = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((L * H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    return (out, lse) if return_lse else out


def evo_attention_bwd(q, k, v, bias, gate, out, lse, do,
                      scale: Optional[float] = None):
    """K2: (dq, dk, dv, dbias fp32 (H, S, S) or None, dgate or None), with
    the wrapper's workspace held meanwhile."""
    L, S, H, C = q.shape
    dev = q.device
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dgate = torch.empty_like(gate) if gate is not None else None
    dbias = (torch.empty((H, S, S), dtype=torch.float32, device=dev)
             if bias is not None else None)
    ws = _scratch(cost.evo_attention_bwd_scratch(
        L, S, H, C, DTYPE_CODES[q.dtype],
        DTYPE_CODES[bias.dtype] if bias is not None else 0,
        int(bias is not None), int(gate is not None)), dev)
    del ws
    return dq, dk, dv, dbias, dgate


def triangle_mult_fwd(xa, xb, xg, w_a, b_a, w_b, b_b, ln_s, ln_b, w_o, b_o,
                      w_g, b_g, k_mask: Optional[torch.Tensor] = None, *,
                      return_s: bool = False):
    """K3: (r_i, r_j, c_z) in xa's dtype; with ``return_s`` also the fp32
    (r_i, r_j, c) contraction; the scratch held meanwhile."""
    r_i, r_k, c_z = xa.shape
    r_j = xb.shape[0]
    c = w_a.shape[1] // 2
    dev = xa.device
    out = torch.empty((r_i, r_j, c_z), dtype=xa.dtype, device=dev)
    s = (torch.empty((r_i, r_j, c), dtype=torch.float32, device=dev)
         if return_s else None)
    scratch = _scratch(cost.triangle_mult_fwd_scratch(
        r_i, r_j, r_k, c, DTYPE_CODES[xa.dtype]), dev)
    del scratch
    return (out, s) if return_s else out


def triangle_mult_bwd_epilogue(s, xg, dy, ln_s, ln_b, w_o, b_o, w_g, b_g):
    """K4: (ds fp32, dxg, dln_s, dln_b, dw_o, db_o, dw_g, db_g), the
    parameter gradients fp32 (views of one vector for the four vectors, as
    the wrapper splits them)."""
    r_i, r_j, c = s.shape
    c_z = xg.shape[-1]
    dt, dev = xg.dtype, s.device
    w_t = ((w_o.t().contiguous(), w_g.t().contiguous())
           if dt == torch.float32 else ())
    ds = torch.empty_like(s)
    dxg = torch.empty_like(xg)
    vec = torch.empty((2 * c + 2 * c_z,), dtype=torch.float32, device=dev)
    dw_o = torch.empty((c, c_z), dtype=torch.float32, device=dev)
    dw_g = torch.empty((c_z, c_z), dtype=torch.float32, device=dev)
    scratch = torch.empty((cost.triangle_mult_bwd_epilogue_scratch(
        r_i * r_j, c_z, c, DTYPE_CODES[dt]),), dtype=torch.float32,
        device=dev)
    del scratch, w_t
    dln_s, dln_b, db_o, db_g = torch.split(vec, (c, c, c_z, c_z))
    return ds, dxg, dln_s, dln_b, dw_o, db_o, dw_g, db_g


def triangle_mult_bwd_dx(ds, x_loc, x_str, w_loc, b_loc, w_str, b_str):
    """K5: (dx_loc, dw_loc fp32, db_loc fp32), the scratch held
    meanwhile."""
    r_p, r_q, c = ds.shape
    r_k, c_z = x_loc.shape[1], x_loc.shape[2]
    dt, dev = x_loc.dtype, ds.device
    w_t = w_loc.t().contiguous() if dt == torch.float32 else None
    dx = torch.empty((r_p, r_k, c_z), dtype=dt, device=dev)
    dw = torch.empty((c_z, 2 * c), dtype=torch.float32, device=dev)
    db = torch.empty((2 * c,), dtype=torch.float32, device=dev)
    scratch = torch.empty((cost.triangle_mult_bwd_dx_scratch(
        r_p, r_q, r_k, c_z, c, DTYPE_CODES[dt]),), dtype=torch.float32,
        device=dev)
    del scratch, w_t
    return dx, dw, db


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None):
    """K6: (B, S, H, D) in q's dtype."""
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)
