"""Wrapper of the hand-written CUDA kernel K6: the LM's causal / plain
grouped-query flash attention forward (``csrc/flash_attention_fwd.cu``;
replaces the Pallas ``repro/kernels/flash_attention.py::flash_attention_fwd``).

``launches`` counts K6's launches: it is raised by one where the kernel is
launched and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "flash_attention_fwd"
SUPPORTED_D = (32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _lib():
    lib = build.load(NAME)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 4 + [i] * 6 + [ll] * 9 + [i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, device):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} dtype {t.dtype} != q's {dtype}")
    if t.dim() != 4:
        raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
    # the kernel reads rows of D elements with 16-byte loads
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: the last dim must be contiguous, the other "
                         f"strides multiples of 8 and the data 16-byte "
                         f"aligned; got strides {t.stride()}")


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None):
    """Launch K6 on CUDA tensors: q (B, S, H, D), k/v (B, T, KV, D) of one
    dtype (float32 or bfloat16), H a multiple of KV, D in (32, 64, 128).
    Returns (B, S, H, D) in q's dtype (contiguous)."""
    global launches
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype} not in {tuple(DTYPE_CODES)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype, q.device)
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, T, KV, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if D not in SUPPORTED_D:
        raise ValueError(f"head dim {D} not in {SUPPORTED_D}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads not a multiple of {KV} kv heads")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if T == 0:
        raise ValueError("no keys: T must be positive")
    scale = D ** -0.5 if scale is None else float(scale)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, KV, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(bool(causal)), DTYPE_CODES[q.dtype], scale,
            stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {err}")
    launches += 1
    return out
