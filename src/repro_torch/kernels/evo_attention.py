"""Wrapper of the hand-written CUDA kernel K1: Evoformer gated-bias attention
forward (``csrc/evo_attention_fwd.cu``; replaces the Pallas
``repro/kernels/flash_attention.py::evo_attention_fwd``).

``launches`` counts the kernel's launches: it is raised by one where the
kernel is launched and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "evo_attention_fwd"
SUPPORTED_C = (4, 8, 16, 32)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _lib():
    lib = build.load(NAME)
    fn = lib.evo_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def _check(name, t, shape, dtypes):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def evo_attention_fwd(q, k, v, bias: Optional[torch.Tensor],
                      gate: Optional[torch.Tensor],
                      scale: Optional[float] = None) -> torch.Tensor:
    """Launch K1 on CUDA tensors: q/k/v/gate (L, S, H, C) of one dtype
    (float32 or bfloat16), bias (H, S, S) float32 or bfloat16; bias and gate
    may be None.  Returns (L, S, H, C) in q's dtype."""
    global launches
    if q.dim() != 4:
        raise ValueError(f"q must be (L, S, H, C), got {tuple(q.shape)}")
    L, S, H, C = q.shape
    if C not in SUPPORTED_C:
        raise ValueError(f"head dim {C} not in {SUPPORTED_C}")
    dt = (q.dtype,)
    _check("q", q, q.shape, tuple(DTYPE_CODES))
    _check("k", k, q.shape, dt)
    _check("v", v, q.shape, dt)
    if gate is not None:
        _check("gate", gate, q.shape, dt)
    if bias is not None:
        _check("bias", bias, (H, S, S), tuple(DTYPE_CODES))
    devs = {t.device for t in (q, k, v, bias, gate) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    scale = C ** -0.5 if scale is None else float(scale)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().evo_attention_fwd(
            ptr(q), ptr(k), ptr(v), ptr(bias), ptr(gate), ptr(out),
            L, S, H, C, DTYPE_CODES[q.dtype],
            DTYPE_CODES[bias.dtype] if bias is not None else 0, scale, stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {err}")
    launches += 1
    return out
