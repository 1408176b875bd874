"""Wrappers of the hand-written CUDA kernels K3, K4 and K5: the fused
triangle-multiplicative update forward (``csrc/triangle_mult_fwd.cu``;
replaces the Pallas ``repro/kernels/triangle.py::triangle_mult_fwd``) and its
backward (``csrc/triangle_mult_bwd.cu``; replaces
``::triangle_mult_bwd_epilogue`` and ``::triangle_mult_bwd_dx``).

``launches`` counts K3's launches, ``epi_launches`` K4's and ``dx_launches``
K5's: one per call each (a kernel's stages, such as K3's gated projections
and contraction or K4's per-pair pass and parameter-gradient sums, run as
one unit).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, cost

NAME = "triangle_mult_fwd"
BWD_NAME = "triangle_mult_bwd"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
epi_launches = 0
dx_launches = 0


def _lib():
    lib = build.load(NAME)
    fn = lib.triangle_mult_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p, ll, ll, p, ll, ll] + [p] * 13 + [ll, p, p]
                       + [i, i, i, i, i, i, p])
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = build.load(BWD_NAME)
    if lib.triangle_mult_bwd_epilogue.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = lib.triangle_mult_bwd_epilogue
        fn.argtypes = [p] * 17 + [ll, ll, i, i, i, p]
        fn.restype = ctypes.c_int
        fn = lib.triangle_mult_bwd_dx
        fn.argtypes = ([p, ll, ll, p, ll, ll, p, ll, ll] + [p] * 9 + [ll]
                       + [i] * 6 + [p])
        fn.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _same_device(tensors):
    if any(t is not None and not t.is_cuda for t in tensors):
        raise ValueError("every input must be a CUDA tensor")
    if len({t.device for t in tensors if t is not None}) != 1:
        raise ValueError("inputs on several devices")


def triangle_mult_fwd(xa, xb, xg, w_a, b_a, w_b, b_b, ln_s, ln_b, w_o, b_o,
                      w_g, b_g, k_mask: Optional[torch.Tensor] = None, *,
                      return_s: bool = False):
    """Launch K3 on CUDA tensors (see ``kernels.ref.triangle_mult_ref`` for
    the function).  xa/xb need only a contiguous channel axis (a transposed
    view is read in place); every other tensor is contiguous and of xa's
    dtype, except ``k_mask`` (r_k,) which is float32.  With ``return_s``
    also returns the fp32 pre-LayerNorm contraction (r_i, r_j, c) that K4
    needs."""
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
    _same_device([xa, xg, k_mask] + [t for t, _ in shapes.values()])
    if dt == torch.bfloat16:
        _check_aligned({"xa": xa, "xb": xb, "xg": xg, "w_a": w_a, "w_b": w_b,
                        "w_o": w_o, "w_g": w_g})
    out = torch.empty((r_i, r_j, c_z), dtype=dt, device=xa.device)
    s = (torch.empty((r_i, r_j, c), dtype=torch.float32, device=xa.device)
         if return_s else None)
    lib = _lib()
    # the gated projections a, b (and on the bf16 path the contraction s)
    scratch = torch.empty(
        (cost.triangle_mult_fwd_scratch(r_i, r_j, r_k, c, DTYPE_CODES[dt]),),
        dtype=torch.uint8, device=xa.device)
    with torch.cuda.device(xa.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.triangle_mult_fwd(
            _ptr(xa), xa.stride(0), xa.stride(1),
            _ptr(xb), xb.stride(0), xb.stride(1),
            _ptr(xg), _ptr(k_mask), _ptr(w_a), _ptr(b_a), _ptr(w_b), _ptr(b_b),
            _ptr(ln_s), _ptr(ln_b), _ptr(w_o), _ptr(b_o), _ptr(w_g), _ptr(b_g),
            _ptr(scratch), scratch.numel(), _ptr(out), _ptr(s),
            r_i, r_j, r_k, c_z, c, DTYPE_CODES[dt], stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {err}")
    launches += 1
    return (out, s) if return_s else out


def _check_aligned(named):
    """The bf16 tensor-core paths copy 16-byte chunks of these tensors' rows:
    base and row strides must be 16-byte aligned."""
    for name, t in named.items():
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:-1]):
            raise ValueError(f"{name} needs 16-byte aligned rows (base and "
                             f"strides), got strides {t.stride()}")


def _check_params(named, dt):
    for name, (t, shape) in named.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.dtype != dt:
            raise ValueError(f"{name} dtype {t.dtype} != {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def triangle_mult_bwd_epilogue(s, xg, dy, ln_s, ln_b, w_o, b_o, w_g, b_g):
    """Launch K4 on CUDA tensors (see
    ``kernels.ref.triangle_mult_bwd_epilogue_ref``): s (r_i, r_j, c) fp32,
    xg / dy (r_i, r_j, c_z) and the parameters of one dtype, all contiguous;
    in bfloat16 c and c_z are multiples of 16, at most 128.  Returns (ds
    fp32, dxg, dln_s, dln_b, dw_o, db_o, dw_g, db_g), the parameter
    gradients fp32."""
    global epi_launches
    r_i, r_j, c = s.shape
    c_z = xg.shape[-1]
    dt = xg.dtype
    if dt not in DTYPE_CODES or s.dtype != torch.float32:
        raise ValueError(f"K4 takes fp32 s and {tuple(DTYPE_CODES)} "
                         f"activations, got {s.dtype} / {dt}")
    named = {"xg": (xg, (r_i, r_j, c_z)), "dy": (dy, (r_i, r_j, c_z)),
             "ln_s": (ln_s, (c,)), "ln_b": (ln_b, (c,)),
             "w_o": (w_o, (c, c_z)), "b_o": (b_o, (c_z,)),
             "w_g": (w_g, (c_z, c_z)), "b_g": (b_g, (c_z,))}
    _check_params(named, dt)
    _check_params({"s": (s, (r_i, r_j, c))}, torch.float32)
    _same_device([s] + [t for t, _ in named.values()])
    if dt == torch.bfloat16:
        if c % 16 or c_z % 16 or c > 128 or c_z > 128:
            raise ValueError(f"K4 in bf16 takes c, c_z multiples of 16 up to "
                             f"128, got c={c}, c_z={c_z}")
        _check_aligned({"xg": xg, "dy": dy, "w_o": w_o, "w_g": w_g})
    dev = s.device
    P = r_i * r_j
    # W_o^T and W_g^T for the fp32 path; the bf16 path reads W in place
    w_o_t, w_g_t = ((w_o.t().contiguous(), w_g.t().contiguous())
                    if dt == torch.float32 else (w_o, w_g))
    ds = torch.empty_like(s)
    dxg = torch.empty_like(xg)
    vec = torch.empty((2 * c + 2 * c_z,), dtype=torch.float32, device=dev)
    dw_o = torch.empty((c, c_z), dtype=torch.float32, device=dev)
    dw_g = torch.empty((c_z, c_z), dtype=torch.float32, device=dev)
    lib = _bwd_lib()
    scratch = torch.empty(
        (cost.triangle_mult_bwd_epilogue_scratch(P, c_z, c, DTYPE_CODES[dt]),),
        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.triangle_mult_bwd_epilogue(
            _ptr(s), _ptr(xg), _ptr(dy), _ptr(ln_s), _ptr(ln_b), _ptr(w_o),
            _ptr(b_o), _ptr(w_g), _ptr(b_g), _ptr(w_o_t), _ptr(w_g_t),
            _ptr(ds), _ptr(dxg), _ptr(vec), _ptr(dw_o), _ptr(dw_g),
            _ptr(scratch), 4 * scratch.numel(), P, c_z, c, DTYPE_CODES[dt],
            stream)
    if err != 0:
        raise RuntimeError(f"{BWD_NAME} (K4) launch failed: cudaError {err}")
    epi_launches += 1
    dln_s, dln_b, db_o, db_g = torch.split(vec, (c, c, c_z, c_z))
    return ds, dxg, dln_s, dln_b, dw_o, db_o, dw_g, db_g


def triangle_mult_bwd_dx(ds, x_loc, x_str, w_loc, b_loc, w_str, b_str):
    """Launch K5 on CUDA tensors (see
    ``kernels.ref.triangle_mult_bwd_dx_ref``): ds (r_p, r_q, c) fp32 and
    x_loc (r_p, r_k, c_z) / x_str (r_q, r_k, c_z) need only a contiguous
    channel axis (transposed views are read in place); the parameters are
    contiguous and of x_loc's dtype.  Returns (dx_loc, dw_loc fp32,
    db_loc fp32)."""
    global dx_launches
    r_p, r_q, c = ds.shape
    r_k, c_z = x_loc.shape[1], x_loc.shape[2]
    dt = x_loc.dtype
    if dt not in DTYPE_CODES or ds.dtype != torch.float32:
        raise ValueError(f"K5 takes fp32 ds and {tuple(DTYPE_CODES)} "
                         f"activations, got {ds.dtype} / {dt}")
    align = 16 if dt == torch.bfloat16 else 4
    if c_z % align or (dt == torch.bfloat16 and c % align):
        raise ValueError(f"c_z={c_z} (and c={c} in bf16) must be multiples "
                         f"of {align} for {dt}")
    if tuple(x_loc.shape) != (r_p, r_k, c_z) or tuple(x_str.shape) != (
            r_q, r_k, c_z) or x_str.dtype != dt:
        raise ValueError(f"x_loc {tuple(x_loc.shape)} / x_str "
                         f"{tuple(x_str.shape)} do not fit ds {tuple(ds.shape)}")
    for name, t in (("ds", ds), ("x_loc", x_loc), ("x_str", x_str)):
        if t.stride(2) != 1:
            raise ValueError(f"{name} needs a contiguous channel axis")
    _check_params({"w_loc": (w_loc, (c_z, 2 * c)), "b_loc": (b_loc, (2 * c,)),
                   "w_str": (w_str, (c_z, 2 * c)), "b_str": (b_str, (2 * c,))},
                  dt)
    _same_device([ds, x_loc, x_str, w_loc, b_loc, w_str, b_str])
    if dt == torch.bfloat16:
        _check_aligned({"x_loc": x_loc, "x_str": x_str, "w_loc": w_loc})
    dev = ds.device
    # W_loc^T for the fp32 path; the bf16 path reads W_loc itself
    w_loc_t = w_loc.t().contiguous() if dt == torch.float32 else w_loc
    dx = torch.empty((r_p, r_k, c_z), dtype=dt, device=dev)
    dw = torch.empty((c_z, 2 * c), dtype=torch.float32, device=dev)
    db = torch.empty((2 * c,), dtype=torch.float32, device=dev)
    lib = _bwd_lib()
    scratch = torch.empty(
        (cost.triangle_mult_bwd_dx_scratch(r_p, r_q, r_k, c_z, c,
                                           DTYPE_CODES[dt]),),
        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.triangle_mult_bwd_dx(
            _ptr(ds), ds.stride(0), ds.stride(1),
            _ptr(x_loc), x_loc.stride(0), x_loc.stride(1),
            _ptr(x_str), x_str.stride(0), x_str.stride(1),
            _ptr(w_loc), _ptr(b_loc), _ptr(w_str), _ptr(b_str), _ptr(w_loc_t),
            _ptr(dx), _ptr(dw), _ptr(db), _ptr(scratch), 4 * scratch.numel(),
            r_p, r_q, r_k, c_z, c, DTYPE_CODES[dt], stream)
    if err != 0:
        raise RuntimeError(f"{BWD_NAME} (K5) launch failed: cudaError {err}")
    dx_launches += 1
    return dx, dw, db
