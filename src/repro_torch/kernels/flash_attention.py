"""Wrapper of the hand-written CUDA kernel K6: the LM's causal / plain
grouped-query flash attention forward (``csrc/flash_attention_fwd.cu``;
replaces the Pallas ``repro/kernels/flash_attention.py::flash_attention_fwd``).

``launches`` counts K6's launches: it is raised by one where the kernel is
launched and nowhere else.
"""
from __future__ import annotations

import array
import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "flash_attention_fwd"
SUPPORTED_D = (32, 64, 112, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


_fn = None


def _kernel():
    """The C entry point of ``csrc/flash_attention_fwd.cu``, built and typed
    at first use."""
    global _fn
    if _fn is None:
        fn = build.load(NAME).flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name, t, dtype, device):
    """The layout the kernel reads: a 4-d CUDA tensor of q's dtype on q's
    device, its last dim contiguous, the other strides multiples of 8 and
    its data 16-byte aligned (rows of D elements in 16-byte loads).  Returns
    its strides."""
    st = t.stride()
    if (t.is_cuda and t.device == device and t.dtype == dtype and len(st) == 4
            and st[3] == 1 and not (st[0] % 8 or st[1] % 8 or st[2] % 8)
            and t.data_ptr() % 16 == 0):
        return st
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} dtype {t.dtype} != q's {dtype}")
    if t.dim() != 4:
        raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
    raise ValueError(f"{name}: the last dim must be contiguous, the other "
                     f"strides multiples of 8 and the data 16-byte "
                     f"aligned; got strides {st}")


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None):
    """Launch K6 on CUDA tensors: q (B, S, H, D), k/v (B, T, KV, D) of one
    dtype (float32 or bfloat16), H a multiple of KV, D in (32, 64, 112,
    128).
    Returns (B, S, H, D) in q's dtype (contiguous)."""
    global launches
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype} not in {tuple(DTYPE_CODES)}")
    dev = q.device
    qs, ks, vs = (_check(n, t, q.dtype, dev) for n, t in (("q", q), ("k", k), ("v", v)))
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if k.shape != (B, T, KV, D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if D not in SUPPORTED_D:
        raise ValueError(f"head dim {D} not in {SUPPORTED_D}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads not a multiple of {KV} kv heads")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    if T == 0:
        raise ValueError("no keys: T must be positive")
    scale = D ** -0.5 if scale is None else float(scale)
    # the kernel's 21 integer arguments as one int64 array
    args = array.array("q", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), B, S, T, H, KV, D, *qs[:3],
                             *ks[:3], *vs[:3], int(bool(causal)),
                             DTYPE_CODES[q.dtype]))
    ptr = args.buffer_info()[0]
    # a prefill calls this once a layer: switch devices only when needed
    if dev.index == torch.cuda.current_device():
        err = _kernel()(ptr, scale, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = _kernel()(ptr, scale, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {err}")
    launches += 1
    return out
