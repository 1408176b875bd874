"""Basic layers: parameter-holding modules plus the functions that apply them.

Counterpart of ``repro/nn/layers.py``.  Conventions:

* A module holds parameters under the JAX pytree's names (``Dense.w`` of
  shape (in, out) and ``Dense.b``; ``LayerNorm.scale`` / ``.bias``), so a
  ``state_dict`` key is the JAX key path joined with dots.
* The apply function takes the module as its ``p`` argument, as the JAX
  functions take a params dict: ``dense(p, x) = x @ p.w + p.b``.
* Modules initialise themselves as the JAX ``*_init`` functions do, drawing
  from a ``torch.Generator``: on the CPU by default (the same seed gives the
  same weights on any device; ``.to(device)`` then places them), or on the
  ``device`` of a generator made there (full-width LM weights are drawn on
  the card, where the host could not hold their fp32 copy).  On ``meta``
  (the dry run) they make the parameters' shapes and dtypes and draw
  nothing (:func:`make_generator` gives no generator there).
* Parameters are fp32 masters; :class:`Policy` casts them to the compute
  dtype once at the model's entry (paper §5.1 AMP recipe), and
  :func:`cast_params` does so through autograd for training.
* Mixed float types promote as in JAX: ``dense`` of a bf16 activation with
  fp32 weights computes in fp32 (the loss heads read the fp32 masters).
"""
from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class Policy:
    """Mixed-precision policy (fp32 params, bf16 activations)."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    def cast(self, module: nn.Module) -> nn.Module:
        """``module`` with floating parameters in the compute dtype, outside
        autograd: the module itself when nothing changes, else a cast copy
        (the fp32 masters are left as they are)."""
        with torch.no_grad():
            return cast_params(module, self.compute_dtype)

    def cast_train(self, module: nn.Module) -> nn.Module:
        """As :meth:`cast`, through autograd (:func:`cast_params`): the
        cast at a training forward's entry."""
        return cast_params(module, self.compute_dtype)


def cast_params(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``module`` with its floating parameters cast to ``dtype`` through
    autograd: the copy holds ``p.to(dtype)`` of each fp32 master, so
    gradients of anything computed from the copy reach the masters (the
    reference's ``Policy.cast`` inside a differentiated function).  The
    module itself when nothing changes."""
    params = [p for p in module.parameters() if p.is_floating_point()]
    if all(p.dtype == dtype for p in params):
        return module
    memo = {id(p): p.to(dtype) for p in params}
    return copy.deepcopy(module, memo)


# ---------------------------------------------------------------------------
# Linear / dense
# ---------------------------------------------------------------------------

def make_generator(device, seed: int):
    """A generator on ``device`` seeded with ``seed``; None on ``meta``, where
    the initialisers below make shapes only and draw nothing."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def lecun_normal(shape, generator: torch.Generator, scale: float = 1.0,
                 device=None):
    """Truncated (±2σ) normal with σ = scale / sqrt(fan_in), fan_in = shape[0],
    drawn on ``device`` (that of ``generator``; the CPU by default).  On
    ``meta`` (the current device, or ``device``) the shape alone."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if w.is_meta:
        return w
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(float(scale) / shape[0] ** 0.5)


class Dense(nn.Module):
    """``w`` (in, out) lecun truncated normal, or zeros for ``scale="zeros"``
    (AF2 final layers); ``b`` zeros, or absent with ``use_bias=False``."""

    def __init__(self, in_dim: int, out_dim: int, *, generator: torch.Generator,
                 use_bias: bool = True, scale: float | str = 1.0,
                 device=None):
        super().__init__()
        if scale == "zeros":
            w = torch.zeros((in_dim, out_dim), device=device)
        else:
            w = lecun_normal((in_dim, out_dim), generator, scale, device)
        self.w = nn.Parameter(w)
        if use_bias:
            self.b = nn.Parameter(torch.zeros((out_dim,), device=device))
        else:
            self.register_parameter("b", None)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    w = p.w
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = x @ w
    if p.b is not None:
        y = y + p.b
    return y


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

class LayerNorm(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((dim,), device=device))
        self.bias = nn.Parameter(torch.zeros((dim,), device=device))


# The normalised output's precision (the reference's §Perf H3 iteration 2):
# statistics are always fp32; with False the output is computed in x's dtype
# (one fp32 round trip of the activation less per LayerNorm).  The dry run's
# ``--ln-bf16`` sets it; the default is the faithful fp32 io.
LN_FP32_IO = True


def set_ln_fp32_io(value: bool) -> None:
    global LN_FP32_IO
    LN_FP32_IO = value


def layernorm(p: LayerNorm, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics and fp32 normalisation, output in x's
    dtype (the reference's default ``LN_FP32_IO=True`` path).  With the
    params in x's dtype this is one ``F.layer_norm`` call, which computes in
    fp32 internally for bf16 inputs; otherwise x is upcast first.  Under
    ``LN_FP32_IO = False`` the statistics stay fp32 and the output is
    computed in x's dtype, as the reference's bf16-io branch does."""
    if not LN_FP32_IO:
        dt = x.dtype
        x32 = x.float()
        var, mu = torch.var_mean(x32, -1, unbiased=False, keepdim=True)
        inv = torch.rsqrt(var + eps).to(dt)
        y = (x - mu.to(dt)) * inv
        return y * p.scale.to(dt) + p.bias.to(dt)
    if p.scale.dtype == x.dtype:
        return F.layer_norm(x, x.shape[-1:], p.scale, p.bias, eps)
    y = F.layer_norm(x.float(), x.shape[-1:], p.scale.float(), p.bias.float(),
                     eps)
    return y.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((dim,), device=device))


def rmsnorm(p: RMSNorm, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 statistics and scaling, output in x's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (y * p.scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding and MLPs
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """``table`` (vocab, dim): standard normal times dim^-1/2."""

    def __init__(self, vocab: int, dim: int, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        t = torch.empty((vocab, dim), device=device)
        if not t.is_meta:
            t = torch.randn((vocab, dim), generator=generator, device=device)
            t.mul_(dim ** -0.5)
        self.table = nn.Parameter(t)


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int, *, generator: torch.Generator,
                 use_bias: bool = False, device=None):
        super().__init__()
        kw = dict(generator=generator, use_bias=use_bias, device=device)
        self.w_gate = Dense(dim, hidden, **kw)
        self.w_up = Dense(dim, hidden, **kw)
        self.w_down = Dense(hidden, dim, **kw)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return dense(p.w_down, F.silu(dense(p.w_gate, x)) * dense(p.w_up, x))


class GeluMLP(nn.Module):
    """``w_in`` (dim, hidden) and ``w_out`` (hidden, dim), both with
    biases."""

    def __init__(self, dim: int, hidden: int, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.w_in = Dense(dim, hidden, **kw)
        self.w_out = Dense(hidden, dim, **kw)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is the erf form)."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp(p: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    return dense(p.w_out, gelu(dense(p.w_in, x)))


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 one-hot of ``idx`` over ``n`` classes, as a comparison with
    ``arange(n)``: the same ops on every device, with no host read
    (``F.one_hot`` reads the indices' range back on the CPU); an index
    outside [0, n) gives a zero row, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def drawn(module: nn.Module, dtype: torch.dtype, cut=None,
          prefix: str = "") -> nn.Module:
    """A module just drawn, cast to ``dtype``; with ``cut`` (a rank's
    ``parallel.fsdp.Layout.cut``) its leaves, keyed under ``prefix``,
    replaced by the rank's slices at once: the families' ``init_params``
    draw one module at a time, so a rank holds at most one whole module
    beside its slices."""
    module = module.to(dtype)
    return module if cut is None else cut(prefix, module)


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
