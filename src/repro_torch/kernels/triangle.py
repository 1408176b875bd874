"""Wrapper of the hand-written CUDA kernel K3: fused triangle-multiplicative
update forward (``csrc/triangle_mult_fwd.cu``; replaces the Pallas
``repro/kernels/triangle.py::triangle_mult_fwd``).

``launches`` counts the kernel's launches (one per call: the gated
projections and the contraction with its epilogue run as one unit).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "triangle_mult_fwd"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _lib():
    lib = build.load(NAME)
    fn = lib.triangle_mult_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p, ll, ll, p, ll, ll] + [p] * 15
                       + [i, i, i, i, i, i, p])
        fn.restype = ctypes.c_int
    return lib


def triangle_mult_fwd(xa, xb, xg, w_a, b_a, w_b, b_b, ln_s, ln_b, w_o, b_o,
                      w_g, b_g, k_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Launch K3 on CUDA tensors (see ``kernels.ref.triangle_mult_ref`` for
    the function).  xa/xb need only a contiguous channel axis (a transposed
    view is read in place); every other tensor is contiguous and of xa's
    dtype, except ``k_mask`` (r_k,) which is float32."""
    global launches
    r_i, r_k, c_z = xa.shape
    r_j = xb.shape[0]
    c = w_a.shape[1] // 2
    dt = xa.dtype
    if dt not in DTYPE_CODES:
        raise ValueError(f"dtype {dt} not in {tuple(DTYPE_CODES)}")
    align = 16 if dt == torch.bfloat16 else 4
    if c_z % align or c % align:
        raise ValueError(f"c_z={c_z} and c={c} must be multiples of {align} "
                         f"for {dt}")
    shapes = {"xb": (xb, (r_j, r_k, c_z)), "xg": (xg, (r_i, r_j, c_z)),
              "w_a": (w_a, (c_z, 2 * c)), "b_a": (b_a, (2 * c,)),
              "w_b": (w_b, (c_z, 2 * c)), "b_b": (b_b, (2 * c,)),
              "ln_s": (ln_s, (c,)), "ln_b": (ln_b, (c,)),
              "w_o": (w_o, (c, c_z)), "b_o": (b_o, (c_z,)),
              "w_g": (w_g, (c_z, c_z)), "b_g": (b_g, (c_z,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.dtype != dt:
            raise ValueError(f"{name} dtype {t.dtype} != {dt}")
        if name not in ("xb",) and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("xa", xa), ("xb", xb)):
        if t.stride(2) != 1:
            raise ValueError(f"{name} needs a contiguous channel axis")
    if k_mask is not None:
        if tuple(k_mask.shape) != (r_k,) or k_mask.dtype != torch.float32:
            raise ValueError("k_mask must be float32 of shape (r_k,)")
        k_mask = k_mask.contiguous()
    tensors = [xa, xg, k_mask] + [t for t, _ in shapes.values()]
    if any(t is not None and not t.is_cuda for t in tensors):
        raise ValueError("every input must be a CUDA tensor")
    if len({t.device for t in tensors if t is not None}) != 1:
        raise ValueError("inputs on several devices")
    out = torch.empty((r_i, r_j, c_z), dtype=dt, device=xa.device)
    # gated projections a, b: (r, r_k, c) on the fp32 path, channel-major
    # (c, r, r_k rounded up to 16) on the bf16 tensor-core path
    r_kp = -(-r_k // 16) * 16
    a_buf = torch.empty((c * r_i * r_kp,), dtype=dt, device=xa.device)
    b_buf = torch.empty((c * r_j * r_kp,), dtype=dt, device=xa.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(xa.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().triangle_mult_fwd(
            ptr(xa), xa.stride(0), xa.stride(1),
            ptr(xb), xb.stride(0), xb.stride(1),
            ptr(xg), ptr(k_mask), ptr(w_a), ptr(b_a), ptr(w_b), ptr(b_b),
            ptr(ln_s), ptr(ln_b), ptr(w_o), ptr(b_o), ptr(w_g), ptr(b_g),
            ptr(a_buf), ptr(b_buf), ptr(out),
            r_i, r_j, r_k, c_z, c, DTYPE_CODES[dt], stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {err}")
    launches += 1
    return out
