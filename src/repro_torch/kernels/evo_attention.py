"""Wrappers of the hand-written CUDA kernels K1 and K2: Evoformer gated-bias
attention forward (``csrc/evo_attention_fwd.cu``; replaces the Pallas
``repro/kernels/flash_attention.py::evo_attention_fwd``) and backward
(``csrc/evo_attention_bwd.cu``; replaces ``::evo_attention_bwd``).

``launches`` counts K1's launches and ``bwd_launches`` K2's: each is raised
by one where its kernel is launched and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "evo_attention_fwd"
BWD_NAME = "evo_attention_bwd"
SUPPORTED_C = (4, 8, 16, 32)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0


def _lib():
    lib = build.load(NAME)
    fn = lib.evo_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = build.load(BWD_NAME)
    fn = lib.evo_attention_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 14 + [i] * 6 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.evo_attention_bwd_workspace.argtypes = [i] * 9
        lib.evo_attention_bwd_workspace.restype = ctypes.c_longlong
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


def _check_inputs(q, k, v, bias, gate):
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


def _ptr(t):
    return None if t is None else t.data_ptr()


def evo_attention_fwd(q, k, v, bias: Optional[torch.Tensor],
                      gate: Optional[torch.Tensor],
                      scale: Optional[float] = None, *,
                      return_lse: bool = False):
    """Launch K1 on CUDA tensors: q/k/v/gate (L, S, H, C) of one dtype
    (float32 or bfloat16), bias (H, S, S) float32 or bfloat16; bias and gate
    may be None.  Returns (L, S, H, C) in q's dtype; with ``return_lse``
    also the fp32 (L*H, S) log-sum-exps that K2 needs."""
    global launches
    _check_inputs(q, k, v, bias, gate)
    L, S, H, C = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((L * H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel() == 0:
        return (out, lse) if return_lse else out
    scale = C ** -0.5 if scale is None else float(scale)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().evo_attention_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(gate), _ptr(out),
            _ptr(lse), L, S, H, C, DTYPE_CODES[q.dtype],
            DTYPE_CODES[bias.dtype] if bias is not None else 0, scale, stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {err}")
    launches += 1
    return (out, lse) if return_lse else out


def evo_attention_bwd(q, k, v, bias, gate, out, lse, do,
                      scale: Optional[float] = None):
    """Launch K2 on CUDA tensors: the flash backward of K1 from its saved
    output ``out`` and ``lse`` (see ``kernels.ref.evo_attention_bwd_ref``).
    ``do`` is the output's cotangent, of q's dtype and shape.  Returns
    (dq, dk, dv, dbias fp32 (H, S, S) or None, dgate or None)."""
    global bwd_launches
    _check_inputs(q, k, v, bias, gate)
    L, S, H, C = q.shape
    _check("out", out, q.shape, (q.dtype,))
    _check("do", do, q.shape, (q.dtype,))
    _check("lse", lse, (L * H, S), (torch.float32,))
    dev = q.device
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dgate = torch.empty_like(gate) if gate is not None else None
    dbias = None
    if bias is not None:
        dbias = torch.empty((H, S, S), dtype=torch.float32, device=dev)
    bias_code = DTYPE_CODES[bias.dtype] if bias is not None else 0
    lib = _bwd_lib()
    # scratch: delta, do_raw, a padded bias copy and the dbias partials, as
    # the kernel's layout needs them
    nbytes = lib.evo_attention_bwd_workspace(
        L, S, H, C, DTYPE_CODES[q.dtype], bias_code, int(bias is not None),
        int(gate is not None),
        int(bias is not None and bias.data_ptr() % 16 != 0))
    ws = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    scale = C ** -0.5 if scale is None else float(scale)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.evo_attention_bwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(gate), _ptr(out),
            _ptr(do), _ptr(lse), _ptr(dq), _ptr(dk), _ptr(dv), _ptr(dgate),
            _ptr(dbias), _ptr(ws), L, S, H, C, DTYPE_CODES[q.dtype],
            bias_code, scale, stream)
    if err != 0:
        raise RuntimeError(f"{BWD_NAME} launch failed: cudaError {err}")
    bwd_launches += 1
    return dq, dk, dv, dbias, dgate
