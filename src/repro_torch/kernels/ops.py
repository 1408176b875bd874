"""Public entry points of the port's kernels (counterpart of
``repro/kernels/ops.py``).

A tensor on the CPU goes to the kernel's plain version (``kernels.ref``); a
CUDA tensor launches the hand-written kernel or raises — there is no
fallback.  The kernels are forward-only: their backward kernels come with
training, so a CUDA call that would need a gradient raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import evo_attention as _ka
from repro_torch.kernels import ref
from repro_torch.kernels import triangle as _kt

# name -> wrapper module holding the ``launches`` counter
KERNELS = {"evo_attention_fwd": _ka, "triangle_mult_fwd": _kt}


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def _on_cuda(*tensors) -> bool:
    dev = tensors[0].device.type
    if dev == "cpu":
        return False
    if dev != "cuda":
        raise ValueError(f"no kernel for device type {dev!r}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError("the CUDA kernels are forward-only; call under "
                           "torch.no_grad()")
    return True


def evo_attention(q, k, v, bias, gate, scale: Optional[float] = None):
    """sigmoid(gate) * attention(q, k, v; bias): q/k/v/gate (L, S, H, C),
    bias (H, S, S) shared across the L rows."""
    if _on_cuda(q, k, v, bias, gate):
        return _ka.evo_attention_fwd(q, k, v, bias, gate, scale)
    return ref.evo_attention_ref(q, k, v, bias, gate, scale)


def evo_attention_nobias(q, k, v, gate, scale: Optional[float] = None):
    """Gated attention with no pair bias (the bias add is compiled out)."""
    if _on_cuda(q, k, v, gate):
        return _ka.evo_attention_fwd(q, k, v, None, gate, scale)
    return ref.evo_attention_ref(q, k, v, None, gate, scale)


def triangle_mult(xa, xb, xg, w_a, b_a, w_b, b_b, ln_s, ln_b, w_o, b_o,
                  w_g, b_g):
    """Fused triangle-multiplicative update, forward only (the reference's
    custom VJP arrives with the backward kernels)."""
    args = (xa, xb, xg, w_a, b_a, w_b, b_b, ln_s, ln_b, w_o, b_o, w_g, b_g)
    if _on_cuda(*args):
        return _kt.triangle_mult_fwd(*args)
    return ref.triangle_mult_ref(*args)


def triangle_mult_masked(xa, xb, xg, k_mask, w_a, b_a, w_b, b_b, ln_s, ln_b,
                         w_o, b_o, w_g, b_g):
    """As :func:`triangle_mult`, with ``k_mask`` (r_k,) zeroing padded
    residues' k-contraction terms in-kernel (padded-bucket serving)."""
    args = (xa, xb, xg, w_a, b_a, w_b, b_b, ln_s, ln_b, w_o, b_o, w_g, b_g)
    if _on_cuda(*args, k_mask):
        return _kt.triangle_mult_fwd(*args, k_mask=k_mask.float())
    return ref.triangle_mult_ref(*args, k_mask=k_mask)
