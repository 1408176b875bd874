"""Mixture-of-Experts transformer (qwen2-moe, phi3.5-moe): counterpart of
``repro/models/moe.py``, serving functions only.

Dense attention (``dense.attention_block``) plus a top-k routed FFN whose
expert banks are padded for even expert-parallel sharding (qwen2-moe: 60
routed experts in 64 bank slots) and, for qwen2-moe, always-active shared
experts as a parallel SwiGLU branch.  Serving is the reference's dropless
path (``moe_ffn_dense``): every bank expert is evaluated and weighted by
the sparse top-k gates, so no token is dropped.  The capacity dispatch of
training (``moe_ffn``, ``capacity_dispatch``, ``sorted_dispatch``, the
router's auxiliary loss) comes with the LM training slice (ROADMAP.md queue
1, item 3) and raises here.

Parameters live in a :class:`MoELM` under the reference's key paths
(``layers.<i>.moe.router.w``, ``layers.<i>.moe.w_gate`` of shape (E_pad,
d, f), ``layers.<i>.moe.shared.w_up.w``); ``bridge`` splits the reference's
stacked layer axis across ``layers``.  ``prefill`` and ``decode_step``
write the cache in place, as ``dense``'s do.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import dense
from repro_torch.models.lmconfig import LMConfig
from repro_torch.nn.layers import (Dense, Embedding, Policy, RMSNorm, SwiGLU,
                                   dense as dense_apply, rmsnorm, swiglu)

BF16 = Policy()

_TRAINING = ("capacity routing is training's (the LM train step, ROADMAP.md "
             "queue 1, item 3); serving runs the dropless moe_ffn_dense")


# ---------------------------------------------------------------------------
# MoE FFN
# ---------------------------------------------------------------------------

def padded_experts(cfg: LMConfig) -> int:
    """Expert-bank extent, padded for even expert-parallel sharding
    (qwen2-moe: 60 routed experts -> 64 bank slots)."""
    return max(cfg.n_experts, cfg.expert_pad_to or cfg.n_experts)


def _expert_bank(e: int, din: int, dout: int, generator, device):
    """(e, din, dout): truncated (±2σ) normal, σ = din^-1/2."""
    w = torch.empty((e, din, dout), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(din ** -0.5)


class MoEFFN(nn.Module):
    """The router over the real experts, the padded banks ``w_gate`` /
    ``w_up`` (E_pad, d, f) and ``w_down`` (E_pad, f, d), and the shared
    experts' SwiGLU when the config has them."""

    def __init__(self, cfg: LMConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        d, e, f = cfg.d_model, padded_experts(cfg), cfg.moe_d_ff
        kw = dict(generator=generator, device=device)
        self.router = Dense(d, cfg.n_experts, use_bias=False, **kw)
        self.w_gate = nn.Parameter(_expert_bank(e, d, f, generator, device))
        self.w_up = nn.Parameter(_expert_bank(e, d, f, generator, device))
        self.w_down = nn.Parameter(_expert_bank(e, f, d, generator, device))
        if cfg.n_shared_experts:
            self.shared = SwiGLU(
                d, cfg.shared_d_ff or cfg.n_shared_experts * f, **kw)


def router_topk(logits, k: int):
    """Top-k gates renormalised over the selected experts: (gates (T, k),
    idx (T, k), probs (T, E)), the softmax in fp32.  Among equal
    probabilities the lower expert index comes first, as ``jax.lax.top_k``
    keeps it (a stable descending sort; ``torch.topk`` promises no order
    among ties, and bf16 router logits tie often)."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def _promoted(*ts):
    """``ts`` in their promoted dtype (as JAX promotes mixed operands)."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return [t.to(dt) for t in ts]


def moe_ffn_dense(p: MoEFFN, cfg: LMConfig, x):
    """Dropless MoE for serving: evaluate every bank expert (padded slots
    included, at gate 0) and weight each by the sparse top-k gates.  The
    fp32 (T, E_pad) gate matrix is cast to the activations' dtype before the
    combine, as the reference casts it."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    logits = dense_apply(p.router, xf)
    gates, idx, _ = router_topk(logits, cfg.top_k)
    w = torch.zeros((xf.shape[0], padded_experts(cfg)), dtype=torch.float32,
                    device=x.device).scatter_add_(1, idx, gates)
    xf, wg, wu, wd = _promoted(xf, p.w_gate, p.w_up, p.w_down)
    # (E_pad, T, f) and (E_pad, T, d): the reference's "td,edf->tef" and
    # "tef,efd->ted" as products batched over the banks, which read each
    # bank in place
    h = torch.matmul(xf, wg)
    u = torch.matmul(xf, wu)
    he = torch.matmul(F.silu(h) * u, wd)
    y = torch.einsum("te,etd->td", *_promoted(w.to(x.dtype), he))
    y = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + swiglu(p.shared, x)
    return y


def moe_ffn(p, cfg: LMConfig, x, **kw):
    raise NotImplementedError(f"moe_ffn: {_TRAINING}")


def capacity_dispatch(idx, gates, n_experts: int, capacity: int):
    raise NotImplementedError(f"capacity_dispatch: {_TRAINING}")


def sorted_dispatch(idx, gates, xf, n_experts: int, capacity: int):
    raise NotImplementedError(f"sorted_dispatch: {_TRAINING}")


# ---------------------------------------------------------------------------
# Full model: dense attention + MoE FFN layers
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    def __init__(self, cfg: LMConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.d_head
        kw = dict(generator=generator, device=device)
        self.ln1 = RMSNorm(d, device=device)
        self.wq = Dense(d, cfg.n_head * hd, use_bias=cfg.qkv_bias, **kw)
        self.wk = Dense(d, cfg.n_kv_head * hd, use_bias=cfg.qkv_bias, **kw)
        self.wv = Dense(d, cfg.n_kv_head * hd, use_bias=cfg.qkv_bias, **kw)
        self.wo = Dense(cfg.n_head * hd, d, use_bias=False, **kw)
        self.ln2 = RMSNorm(d, device=device)
        self.moe = MoEFFN(cfg, **kw)


class MoELM(nn.Module):
    """All parameters, drawn on ``device`` (``cuda`` by default, raising
    without a card unless ``device="cpu"``) from a generator there seeded
    with ``seed``, one module at a time, each cast to ``dtype`` as soon as
    it is drawn (as ``dense.DenseLM``)."""

    def __init__(self, cfg: LMConfig, *, seed: int = 0, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator(device=device).manual_seed(seed)
        kw = dict(generator=g, device=device)
        self.embed = Embedding(cfg.vocab, cfg.d_model, **kw).to(dtype)
        self.layers = nn.ModuleList(Layer(cfg, **kw).to(dtype)
                                    for _ in range(cfg.n_layer))
        self.ln_f = RMSNorm(cfg.d_model, device=device).to(dtype)
        self.lm_head = Dense(cfg.d_model, cfg.vocab, use_bias=False,
                             **kw).to(dtype)


def init_params(cfg: LMConfig, *, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32) -> MoELM:
    return MoELM(cfg, seed=seed, device=device, dtype=dtype)


def _dropless_layer(lp: Layer, cfg: LMConfig, x, positions):
    att, kv = dense.attention_block(lp, cfg, x, positions)
    x = x + att
    x = x + moe_ffn_dense(lp.moe, cfg, rmsnorm(lp.ln2, x))
    return x.to(att.dtype), kv


def backbone(params: MoELM, cfg: LMConfig, x, positions, *,
             dropless: bool = True):
    """The layer stack on embeddings x (B, S, D), then ``ln_f``; only the
    dropless (serving) routing."""
    if not dropless:
        raise NotImplementedError(f"forward(dropless=False): {_TRAINING}")
    for lp in params.layers:
        x, _ = _dropless_layer(lp, cfg, x, positions)
    return rmsnorm(params.ln_f, x)


def forward(params: MoELM, cfg: LMConfig, tokens, *, dropless: bool = False):
    """tokens (B, S) -> (logits (B, S, V) in bf16, aux 0): the reference's
    ``forward(..., dropless=True)``, inference semantics.  Its default, the
    capacity routing of training, raises."""
    if not dropless:
        raise NotImplementedError(f"forward(dropless=False): {_TRAINING}")
    params = BF16.cast(params)
    b, s = tokens.shape
    x = params.embed.table[tokens.long()]
    x = backbone(params, cfg, x, dense._positions(b, s, x.device))
    return (dense_apply(params.lm_head, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


# serving: the cache layout is dense's
init_cache = dense.init_cache


@torch.no_grad()
def prefill(params: MoELM, cfg: LMConfig, tokens, cache):
    """Fill the cache with the prompt tokens (B, S); returns (last-token
    logits (B, 1, V), cache)."""
    params = BF16.cast(params)
    b, s = tokens.shape
    x = params.embed.table[tokens.long()]
    positions = dense._positions(b, s, x.device)
    for i, lp in enumerate(params.layers):
        x, (k, v) = _dropless_layer(lp, cfg, x, positions)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    x = rmsnorm(params.ln_f, x)
    logits = dense_apply(params.lm_head, x[:, -1:])
    return logits, {"k": cache["k"], "v": cache["v"],
                    "length": torch.full((b,), s, dtype=torch.int32,
                                         device=x.device)}


@torch.no_grad()
def decode_step(params: MoELM, cfg: LMConfig, tokens1, cache):
    """One decode step: tokens1 (B, 1) -> (logits (B, 1, V), cache)."""
    params = BF16.cast(params)
    x = params.embed.table[tokens1.long()]
    length = cache["length"]
    for i, lp in enumerate(params.layers):
        x = x + dense.decode_attention_block(lp, cfg, rmsnorm(lp.ln1, x),
                                             cache["k"][i], cache["v"][i],
                                             length)
        y = moe_ffn_dense(lp.moe, cfg, rmsnorm(lp.ln2, x))
        x = (x + y).to(y.dtype)
    x = rmsnorm(params.ln_f, x)
    logits = dense_apply(params.lm_head, x)
    return logits, {"k": cache["k"], "v": cache["v"], "length": length + 1}
