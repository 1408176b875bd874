"""Public entry points of the port's kernels (counterpart of
``repro/kernels/ops.py``).

A tensor on the CPU goes to the kernel's plain version (``kernels.ref``); a
CUDA tensor launches the hand-written kernel or raises — there is no
fallback.  A ``meta`` tensor (the dry run) takes the kernel's meta route
(``kernels.meta``): the kernel's output shapes and temporaries, no values;
any other device raises.  Without a gradient to track, the forward kernels
K1, K3 and K6 take their serving launch.  When autograd needs the backward, each entry point
runs as a ``torch.autograd.Function`` whose forward also writes the
residual (K1's log-sum-exp, K3's fp32 contraction s) and whose backward is
the flash-attention backward K2, or the triangle backward K4 + K5 — the
VJPs of the reference's ``_ea_bwd``, ``_eanb_bwd`` and ``_tm_bwd``.
``triangle_mult_masked`` stays forward-only on the card, as in the
reference.  The LM's ``flash_attention`` (K6) keeps the reference's
backward: autograd through the plain chunked attention, recomputed from q,
k and v (the reference's ``_fa_bwd`` is chunked XLA, not a kernel).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import trace_hooks
from repro_torch.kernels import evo_attention as _ka
from repro_torch.kernels import flash_attention as _kf
from repro_torch.kernels import meta as _meta
from repro_torch.kernels import ref
from repro_torch.kernels import triangle as _kt
from repro_torch.nn.attention import attention_chunked

# kernel name -> (wrapper module, its launch counter)
KERNELS = {"evo_attention_fwd": (_ka, "launches"),
           "evo_attention_bwd": (_ka, "bwd_launches"),
           "triangle_mult_fwd": (_kt, "launches"),
           "triangle_mult_bwd_epilogue": (_kt, "epi_launches"),
           "triangle_mult_bwd_dx": (_kt, "dx_launches"),
           "flash_attention_fwd": (_kf, "launches")}


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` ({kernel name: launches}) to the launch counters: a
    replayed CUDA graph credits the launches it holds (``graphs.py``)."""
    for name, n in counts.items():
        mod, attr = KERNELS[name]
        setattr(mod, attr, getattr(mod, attr) + n)


def _k(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``: kernel ``name`` or its plain version; one
    kernel node while an op trace records kernel nodes."""
    trace = trace_hooks.ACTIVE
    if trace is None or not trace.kernel_nodes:
        return fn(*args, **kwargs)
    return trace_hooks.kernel_node(name, fn, *args, **kwargs)


def _on_cuda(*tensors) -> bool:
    dev = tensors[0].device.type
    if dev == "cpu":
        return False
    if dev != "cuda":
        raise ValueError(f"no kernel for device type {dev!r}")
    return True


def _route(kernel, plain, meta, *tensors):
    """The function a call runs: on ``meta`` the kernel's meta route
    (``kernels.meta``: its outputs' shapes and its temporaries, no values),
    else the kernel on a CUDA tensor and its plain version on a CPU tensor
    (:func:`_on_cuda`, which raises for any other device)."""
    if tensors[0].device.type == "meta":
        return meta
    return kernel if _on_cuda(*tensors) else plain


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# LM flash attention: K6 forward, the plain chunked attention's backward
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        fwd = _route(_kf.flash_attention_fwd, ref.flash_attention_ref,
                     _meta.flash_attention_fwd, q)
        return _k("flash_attention_fwd", fwd, q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attention_chunked(*qkv, causal=ctx.causal, scale=ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, qkv, do)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """Grouped-query attention: q (B, S, H, D), k/v (B, T, KV, D), H a
    multiple of KV; ``causal``: query i sees keys 0..i."""
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, scale)
    fwd = _route(_kf.flash_attention_fwd, ref.flash_attention_ref,
                 _meta.flash_attention_fwd, q, k, v)
    return _k("flash_attention_fwd", fwd, q, k, v, causal, scale)


# ---------------------------------------------------------------------------
# Gated-bias attention: K1 forward, K2 backward
# ---------------------------------------------------------------------------

class _EvoAttention(torch.autograd.Function):
    """sigmoid(gate) * attention(q, k, v; bias) with the flash backward;
    bias and gate may be None (their gradients are then None)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, gate, scale):
        fwd = _route(_ka.evo_attention_fwd, ref.evo_attention_ref,
                     _meta.evo_attention_fwd, q)
        out, lse = _k("evo_attention_fwd", fwd, q, k, v, bias, gate, scale,
                      return_lse=True)
        ctx.save_for_backward(q, k, v, bias, gate, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, gate, out, lse = ctx.saved_tensors
        bwd = _route(_ka.evo_attention_bwd, ref.evo_attention_bwd_ref,
                     _meta.evo_attention_bwd, q)
        dq, dk, dv, dbias, dgate = _k("evo_attention_bwd", bwd, q, k, v,
                                      bias, gate, out, lse, do.contiguous(),
                                      ctx.scale)
        if dbias is not None:
            dbias = dbias.to(bias.dtype)
        return dq, dk, dv, dbias, dgate, None


def evo_attention(q, k, v, bias, gate, scale: Optional[float] = None):
    """sigmoid(gate) * attention(q, k, v; bias): q/k/v/gate (L, S, H, C),
    bias (H, S, S) shared across the L rows."""
    if _needs_grad(q, k, v, bias, gate):
        return _EvoAttention.apply(q, k, v, bias, gate, scale)
    fwd = _route(_ka.evo_attention_fwd, ref.evo_attention_ref,
                 _meta.evo_attention_fwd, q, k, v, bias, gate)
    return _k("evo_attention_fwd", fwd, q, k, v, bias, gate, scale)


def evo_attention_nobias(q, k, v, gate, scale: Optional[float] = None):
    """Gated attention with no pair bias (the bias add is compiled out)."""
    if _needs_grad(q, k, v, gate):
        return _EvoAttention.apply(q, k, v, None, gate, scale)
    fwd = _route(_ka.evo_attention_fwd, ref.evo_attention_ref,
                 _meta.evo_attention_fwd, q, k, v, gate)
    return _k("evo_attention_fwd", fwd, q, k, v, None, gate, scale)


def evo_attention_nogate(q, k, v, bias, scale: Optional[float] = None):
    """Bias attention with no gate (the gate multiply is compiled out): the
    LM dispatcher's biased self-attention, ``attention(impl="pallas",
    bias=...)``.  q/k/v (L, S, H, C), bias (H, S, S)."""
    if _needs_grad(q, k, v, bias):
        return _EvoAttention.apply(q, k, v, bias, None, scale)
    fwd = _route(_ka.evo_attention_fwd, ref.evo_attention_ref,
                 _meta.evo_attention_fwd, q, k, v, bias)
    return _k("evo_attention_fwd", fwd, q, k, v, bias, None, scale)


# ---------------------------------------------------------------------------
# Triangle-multiplicative update: K3 forward, K4 + K5 backward
# ---------------------------------------------------------------------------

class _TriangleMult(torch.autograd.Function):
    """The fused update with the reference's VJP (``_tm_bwd``): K4 from the
    saved contraction s, then K5 once per operand side, the second time
    with the operands swapped and ds transposed."""

    @staticmethod
    def forward(ctx, xa, xb, xg, w_a, b_a, w_b, b_b, ln_s, ln_b, w_o, b_o,
                w_g, b_g):
        args = (xa, xb, xg, w_a, b_a, w_b, b_b, ln_s, ln_b, w_o, b_o, w_g, b_g)
        fwd = _route(_kt.triangle_mult_fwd, ref.triangle_mult_ref,
                     _meta.triangle_mult_fwd, xa)
        y, s = _k("triangle_mult_fwd", fwd, *args, return_s=True)
        ctx.save_for_backward(*args, s)
        return y

    @staticmethod
    def backward(ctx, dy):
        (xa, xb, xg, w_a, b_a, w_b, b_b, ln_s, ln_b, w_o, b_o, w_g, b_g,
         s) = ctx.saved_tensors
        epi = _route(_kt.triangle_mult_bwd_epilogue,
                     ref.triangle_mult_bwd_epilogue_ref,
                     _meta.triangle_mult_bwd_epilogue, xa)
        bwd_dx = _route(_kt.triangle_mult_bwd_dx, ref.triangle_mult_bwd_dx_ref,
                        _meta.triangle_mult_bwd_dx, xa)
        ds, dxg, dln_s, dln_b, dw_o, db_o, dw_g, db_g = _k(
            "triangle_mult_bwd_epilogue", epi, s, xg, dy.contiguous(), ln_s,
            ln_b, w_o, b_o, w_g, b_g)
        dxa, dw_a, db_a = _k("triangle_mult_bwd_dx", bwd_dx, ds, xa, xb, w_a,
                             b_a, w_b, b_b)
        dxb, dw_b, db_b = _k("triangle_mult_bwd_dx", bwd_dx,
                             ds.transpose(0, 1), xb, xa, w_b, b_b, w_a, b_a)
        cast = lambda g, p: g.to(p.dtype)
        return (dxa, dxb, dxg, cast(dw_a, w_a), cast(db_a, b_a),
                cast(dw_b, w_b), cast(db_b, b_b), cast(dln_s, ln_s),
                cast(dln_b, ln_b), cast(dw_o, w_o), cast(db_o, b_o),
                cast(dw_g, w_g), cast(db_g, b_g))


def triangle_mult(xa, xb, xg, w_a, b_a, w_b, b_b, ln_s, ln_b, w_o, b_o,
                  w_g, b_g):
    """Fused triangle-multiplicative update, differentiable in all its
    arguments through K4/K5 (their plain versions on CPU tensors)."""
    args = (xa, xb, xg, w_a, b_a, w_b, b_b, ln_s, ln_b, w_o, b_o, w_g, b_g)
    if _needs_grad(*args):
        return _TriangleMult.apply(*args)
    fwd = _route(_kt.triangle_mult_fwd, ref.triangle_mult_ref,
                 _meta.triangle_mult_fwd, *args)
    return _k("triangle_mult_fwd", fwd, *args)


def triangle_mult_masked(xa, xb, xg, k_mask, w_a, b_a, w_b, b_b, ln_s, ln_b,
                         w_o, b_o, w_g, b_g):
    """As :func:`triangle_mult`, with ``k_mask`` (r_k,) zeroing padded
    residues' k-contraction terms in-kernel (padded-bucket serving).
    Forward-only on the card, as the reference wires no VJP for it: a CUDA
    call that autograd would need a gradient from raises."""
    args = (xa, xb, xg, w_a, b_a, w_b, b_b, ln_s, ln_b, w_o, b_o, w_g, b_g)
    if xa.device.type == "meta":
        return _k("triangle_mult_fwd", _meta.triangle_mult_fwd, *args,
                  k_mask=k_mask.float())
    if _on_cuda(*args, k_mask):
        if _needs_grad(*args, k_mask):
            raise RuntimeError("triangle_mult_masked is forward-only (padded-"
                               "bucket serving); call it under torch.no_grad()")
        return _k("triangle_mult_fwd", _kt.triangle_mult_fwd, *args,
                  k_mask=k_mask.float())
    return _k("triangle_mult_fwd", ref.triangle_mult_ref, *args,
              k_mask=k_mask)
