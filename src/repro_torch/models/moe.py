"""Mixture-of-Experts transformer (qwen2-moe, phi3.5-moe): counterpart of
``repro/models/moe.py``, the partition rules (``partition_rules``)
included.

Dense attention (``dense.attention_block``) plus a top-k routed FFN whose
expert banks are padded for even expert-parallel sharding (qwen2-moe: 60
routed experts in 64 bank slots) and, for qwen2-moe, always-active shared
experts as a parallel SwiGLU branch.  Serving is the reference's dropless
path (``moe_ffn_dense``): every bank expert is evaluated and weighted by
the sparse top-k gates, so no token is dropped.  Training routes each
token's top-k choices into expert buffers of ``capacity`` slots
(``moe_ffn``), by the one-hot dispatch (``capacity_dispatch``,
``cfg.moe_dispatch="einsum"``) or by a stable sort (``sorted_dispatch``,
``"sorted"``), which drop the same overflowing choices, and adds the
router's load-balancing loss.  Under data parallelism
(``parallel.fsdp.data_parallel``) the routing is the global batch's, as
the reference's GSPMD step computes it: the capacity is the global token
count's, a choice's buffer position counts the earlier choices of every
rank (the (k, T) order over the rows of all ranks), and the load-balancing
statistics are summed over the axis.

Under tensor parallelism (``parallel.tensor``) the banks are split along
the expert axis (expert parallelism) and the router is replicated: each
rank computes its own experts' share, for dropless serving and for the
capacity routing alike (the dispatch and the gates are the whole batch's,
computed on every rank, and read through ``tensor.copy_in`` for the
rank's experts), the shared experts column- then row-parallel, and one
all-reduce over ``model`` combines them.

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
from repro_torch.nn.partition import P
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import fsdp
from repro_torch.parallel import tensor
from repro_torch.nn.layers import (Dense, Embedding, Policy, RMSNorm, SwiGLU,
                                   dense as dense_apply, drawn, rmsnorm,
                                   swiglu, make_generator)

BF16 = Policy()


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


def _local_experts(p: MoEFFN, cfg: LMConfig):
    """This rank's range of the bank's experts (None: all of them)."""
    return tensor.split_of(p.w_gate.shape[0], padded_experts(cfg),
                           "moe/w_gate")


def _combine(p: MoEFFN, cfg: LMConfig, x, y, experts):
    """``y`` (the routed experts' output: this rank's experts' share where
    ``experts`` is a range) plus the shared experts'; the shares summed
    over ``model`` in one all-reduce."""
    whole, shares = (y, None) if experts is None else (None, y)
    if cfg.n_shared_experts:
        d_ff = cfg.shared_d_ff or cfg.n_shared_experts * cfg.moe_d_ff
        sp = p.shared
        if tensor.split_of(sp.w_gate.w.shape[-1], d_ff, "moe/shared") is None:
            sh = swiglu(sp, x)
            whole = sh if whole is None else whole + sh
        else:
            h = tensor.copy_in(x)
            sh = dense_apply(sp.w_down, F.silu(dense_apply(sp.w_gate, h))
                             * dense_apply(sp.w_up, h))
            shares = sh if shares is None else shares + sh
    if shares is None:
        return whole
    shares = tensor.reduce_out(shares)
    return shares if whole is None else whole + shares


def moe_ffn_dense(p: MoEFFN, cfg: LMConfig, x):
    """Dropless MoE for serving: evaluate every bank expert (padded slots
    included, at gate 0) and weight each by the sparse top-k gates.  The
    fp32 (T, E_pad) gate matrix is cast to the activations' dtype before the
    combine, as the reference casts it.  Expert-parallel: this rank's
    experts."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    logits = dense_apply(p.router, xf)
    gates, idx, _ = router_topk(logits, cfg.top_k)
    w = torch.zeros((xf.shape[0], padded_experts(cfg)), dtype=torch.float32,
                    device=x.device).scatter_add_(1, idx, gates)
    experts = _local_experts(p, cfg)
    if experts is not None:
        w, xf = tensor.narrow(tensor.copy_in(w), 1, experts), \
            tensor.copy_in(xf)
    xf, wg, wu, wd = _promoted(xf, p.w_gate, p.w_up, p.w_down)
    # (E_pad, T, f) and (E_pad, T, d): the reference's "td,edf->tef" and
    # "tef,efd->ted" as products batched over the banks, which read each
    # bank in place
    h = torch.matmul(xf, wg)
    u = torch.matmul(xf, wu)
    he = torch.matmul(F.silu(h) * u, wd)
    y = torch.einsum("te,etd->td", *_promoted(w.to(x.dtype), he))
    return _combine(p, cfg, x, y.reshape(b, s, d), experts)


def capacity_dispatch(idx, gates, n_experts: int, capacity: int,
                      shift=None):
    """The one-hot dispatch (T, E, C) and combine (T, E, C) tensors.  A
    choice's position in its expert's buffer is the count of earlier
    choices of that expert in the flattened (k, T) order (every token's
    first choice before any second), plus ``shift[j, e]`` for a choice j
    of expert e (:func:`global_shift`); choices at positions past
    ``capacity`` are dropped (their residual passes through)."""
    t, k = idx.shape
    flat_idx = idx.T.reshape(-1)                             # (kT,)
    onehot = F.one_hot(flat_idx, n_experts)                  # (kT, E)
    pos = ((torch.cumsum(onehot, 0) - 1) * onehot).sum(-1)   # (kT,)
    if shift is not None:
        j = torch.arange(t * k, device=idx.device) // t
        pos = pos + shift[j, flat_idx]
    keep = pos < capacity
    # jax.nn.one_hot gives a zero row past ``capacity``; those rows are
    # dropped here
    pos_oh = (F.one_hot(torch.clamp(pos, max=capacity - 1), capacity)
              .float() * keep[:, None])
    disp = onehot.float()[:, :, None] * pos_oh[:, None, :]  # (kT, E, C)
    disp = disp.reshape(k, t, n_experts, capacity)
    combine = disp * gates.T.reshape(k, t, 1, 1)
    return disp.sum(0), combine.sum(0)


def sorted_dispatch(idx, gates, xf, n_experts: int, capacity: int,
                    shift=None):
    """The capacity dispatch of :func:`capacity_dispatch` (``shift``
    likewise) by a stable sort of the choices by expert and one scatter:
    returns (xe (E, C, D), slot_by_tk (k, T), keep_by_tk (k, T)), each
    choice's buffer slot and whether it was kept, so that the combine is a
    gather."""
    t, k = idx.shape
    d = xf.shape[-1]
    flat_e = idx.T.reshape(-1)                               # (kT,)
    order = torch.sort(flat_e, stable=True).indices          # by expert
    sorted_e = flat_e[order]
    ranks = torch.arange(t * k, device=idx.device)
    experts = torch.arange(n_experts, device=idx.device,
                           dtype=sorted_e.dtype)
    seg_start = torch.searchsorted(sorted_e, experts, side="left")
    pos_sorted = ranks - seg_start[sorted_e]
    if shift is not None:
        pos_sorted = pos_sorted + shift[order // t, sorted_e]
    keep_sorted = pos_sorted < capacity
    token_sorted = order % t
    slot_sorted = sorted_e * capacity + torch.clamp(pos_sorted,
                                                    max=capacity - 1)
    # dropped choices add zeros into their expert's last slot
    src = torch.where(keep_sorted[:, None], xf[token_sorted],
                      torch.zeros((), dtype=xf.dtype, device=xf.device))
    xe = torch.zeros((n_experts * capacity, d), dtype=xf.dtype,
                     device=xf.device).index_add(0, slot_sorted, src)
    inv = torch.empty_like(order)
    inv[order] = ranks
    return (xe.reshape(n_experts, capacity, d),
            slot_sorted[inv].reshape(k, t), keep_sorted[inv].reshape(k, t))


def _expert_ffn(p: MoEFFN, xe):
    """Each bank expert's SwiGLU on its buffer: xe (E, C, D) -> (E, C, D)."""
    xe, wg, wu, wd = _promoted(xe, p.w_gate, p.w_up, p.w_down)
    return torch.matmul(F.silu(torch.matmul(xe, wg)) * torch.matmul(xe, wu),
                        wd)


@torch.no_grad()
def global_shift(idx, n_experts: int, axis):
    """(k, E): what a rank adds to its choices' buffer positions (counted
    over its own (k, T) choices) to place them in the global (k, T) order
    over the rows of every rank of ``axis`` (rank order): for choice slot
    j of expert e, every rank's choices of e in slots before j plus the
    choices of e in slot j of the ranks before this one, less this rank's
    own choices of e in slots before j.  One all-gather of the (k, E)
    counts."""
    counts = F.one_hot(idx.T, n_experts).sum(1)              # (k, E)
    every = coll.all_gather(counts[None], axis, 0)          # (N, k, E)
    total = every.sum(0)
    return ((torch.cumsum(total, 0) - total)
            + every[:axis.index].sum(0)
            - (torch.cumsum(counts, 0) - counts))


def expert_capacity(cfg: LMConfig, t: int) -> int:
    """Slots of each expert's buffer for ``t`` tokens."""
    return int(cfg.capacity_factor * cfg.top_k * t / cfg.n_experts + 1)


def moe_ffn(p: MoEFFN, cfg: LMConfig, x, *, return_aux: bool = False):
    """Training's capacity-routed MoE: x (B, S, D) -> (B, S, D), with
    ``return_aux`` also the Switch/GShard load-balancing loss E * sum_e f_e
    P_e (f_e the share of first choices, P_e the mean router
    probability).  Under ``fsdp.data_parallel`` the rows are this rank's
    of the global batch, routed as the global batch is (see the module
    docstring): the buffers have the global capacity, and hold this rank's
    choices at their global positions."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    logits = dense_apply(p.router, xf)                       # (T, E)
    gates, idx, probs = router_topk(logits, cfg.top_k)
    axis = fsdp.current_data_axis()
    if axis is not None and axis.size == 1:
        axis = None
    t_all = t if axis is None else t * axis.size
    cap = expert_capacity(cfg, t_all)
    e_pad = padded_experts(cfg)
    shift = None if axis is None else global_shift(idx, e_pad, axis)
    experts = _local_experts(p, cfg)
    lo, hi = experts or (0, e_pad)
    if experts is not None:
        # the dispatch is the whole batch's; this rank's experts read it
        xf, gates = tensor.copy_in(xf), tensor.copy_in(gates)
    if cfg.moe_dispatch == "sorted":
        xe, slot_by_tk, keep_by_tk = sorted_dispatch(idx, gates, xf, e_pad,
                                                     cap, shift)
        he = _expert_ffn(p, xe[lo:hi]).reshape((hi - lo) * cap, d)
        slot = slot_by_tk - lo * cap
        mine = (slot >= 0) & (slot < (hi - lo) * cap)
        picked = he[slot.clamp(0, (hi - lo) * cap - 1)]      # (k, T, D)
        w = (gates.T * (keep_by_tk & mine)).to(x.dtype)      # (k, T)
        y = torch.einsum("kt,ktd->td", *_promoted(w, picked))
    else:   # 'einsum': the GShard one-hot dispatch
        disp, combine = capacity_dispatch(idx, gates, e_pad, cap, shift)
        disp, combine = disp[:, lo:hi], combine[:, lo:hi]
        xe = torch.einsum("tec,td->ecd", *_promoted(disp.to(x.dtype), xf))
        he = _expert_ffn(p, xe)
        y = torch.einsum("tec,ecd->td", *_promoted(combine.to(x.dtype), he))
    y = _combine(p, cfg, x, y.reshape(b, s, d), experts)
    if not return_aux:
        return y
    fe = F.one_hot(idx[:, 0], cfg.n_experts).float()
    if axis is None:
        me, fe = probs.mean(0), fe.mean(0)
    else:
        me = coll.psum(probs.sum(0), axis) / t_all
        fe = coll.psum(fe.sum(0), axis) / t_all
    return y, cfg.n_experts * (me * fe).sum()


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
                 dtype: torch.dtype = torch.float32, cut=None):
        super().__init__()
        device = resolve_device(device)
        g = make_generator(device, seed)
        kw = dict(generator=g, device=device)
        self.embed = drawn(Embedding(cfg.vocab, cfg.d_model, **kw), dtype,
                           cut, "embed.")
        self.layers = nn.ModuleList(
            drawn(Layer(cfg, **kw), dtype, cut, f"layers.{i}.")
            for i in range(cfg.n_layer))
        self.ln_f = drawn(RMSNorm(cfg.d_model, device=device), dtype, cut,
                          "ln_f.")
        self.lm_head = drawn(Dense(cfg.d_model, cfg.vocab, use_bias=False,
                                   **kw), dtype, cut, "lm_head.")


def init_params(cfg: LMConfig, *, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32, cut=None) -> MoELM:
    return MoELM(cfg, seed=seed, device=device, dtype=dtype, cut=cut)


def _dropless_layer(lp: Layer, cfg: LMConfig, x, positions, cache=None):
    att, kv = dense.attention_block(lp, cfg, x, positions, cache=cache)
    x = x + att
    x = x + moe_ffn_dense(lp.moe, cfg, rmsnorm(lp.ln2, x))
    return x.to(att.dtype), kv


def _layer(lp: Layer, cfg: LMConfig, x, positions):
    """Training's layer: (x, aux)."""
    att, _ = dense.attention_block(lp, cfg, x, positions)
    x = x + att
    y, aux = moe_ffn(lp.moe, cfg, rmsnorm(lp.ln2, x), return_aux=True)
    return (x + y).to(att.dtype), aux


def _stack(params: MoELM, cfg: LMConfig, x, positions, dropless: bool):
    """The layer stack, each layer under ``dense.remat``, then ``ln_f``:
    (x, the router losses' sum over the layers; 0 when dropless)."""
    def one(lp, x):
        if dropless:
            return _dropless_layer(lp, cfg, x, positions)[0], aux0
        return _layer(lp, cfg, x, positions)

    aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = aux0
    one = dense.remat(cfg, one)
    for lp in params.layers:
        x, a = one(lp, x)
        aux = aux + a
    return rmsnorm(params.ln_f, x), aux


def backbone(params: MoELM, cfg: LMConfig, x, positions, *,
             dropless: bool = True):
    """The layer stack on embeddings x (B, S, D), then ``ln_f``; by default
    the dropless (serving) routing."""
    return _stack(params, cfg, x, positions, dropless)[0]


def forward(params: MoELM, cfg: LMConfig, tokens, *, dropless: bool = False):
    """tokens (B, S) -> (logits (B, S, V) in bf16, the router loss averaged
    over the layers): training's capacity routing, or with
    ``dropless=True`` the inference semantics of prefill and decode (the
    loss is then 0)."""
    params = BF16.cast_train(params)
    b, s = tokens.shape
    x = dense.embed(params, cfg, tokens)
    x, aux = _stack(params, cfg, x, dense._positions(b, s, x.device),
                    dropless)
    return dense.logits_fn(params, cfg, x), aux / cfg.n_layer


def loss(params: MoELM, cfg: LMConfig, batch: dict):
    logits, aux = forward(params, cfg, batch["tokens"])
    ce = tensor.cross_entropy(logits, batch["labels"], cfg.vocab,
                              mask=batch.get("mask"))
    return ce + cfg.router_aux_weight * aux


# serving: the cache layout is dense's
init_cache = dense.init_cache


@torch.no_grad()
def prefill(params: MoELM, cfg: LMConfig, tokens, cache):
    """Fill the cache with the prompt tokens (B, S); returns (last-token
    logits (B, 1, V), cache)."""
    params = BF16.cast(params)
    b, s = tokens.shape
    x = dense.embed(params, cfg, tokens)
    positions = dense._positions(b, s, x.device)
    for i, lp in enumerate(params.layers):
        x, (k, v) = _dropless_layer(lp, cfg, x, positions, cache["k"][i])
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    x = rmsnorm(params.ln_f, x)
    logits = dense.logits_fn(params, cfg, x[:, -1:])
    return logits, {"k": cache["k"], "v": cache["v"],
                    "length": torch.full((b,), s, dtype=torch.int32,
                                         device=x.device)}


@torch.no_grad()
def decode_step(params: MoELM, cfg: LMConfig, tokens1, cache):
    """One decode step: tokens1 (B, 1) -> (logits (B, 1, V), cache)."""
    params = BF16.cast(params)
    x = dense.embed(params, cfg, tokens1)
    length = cache["length"]
    for i, lp in enumerate(params.layers):
        x = x + dense.decode_attention_block(lp, cfg, rmsnorm(lp.ln1, x),
                                             cache["k"][i], cache["v"][i],
                                             length)
        y = moe_ffn_dense(lp.moe, cfg, rmsnorm(lp.ln2, x))
        x = (x + y).to(y.dtype)
    x = rmsnorm(params.ln_f, x)
    logits = dense.logits_fn(params, cfg, x)
    return logits, {"k": cache["k"], "v": cache["v"], "length": length + 1}


# ---------------------------------------------------------------------------
# partitioning: dense's rules, the expert banks over the expert axis
# ---------------------------------------------------------------------------

def partition_rules(cfg: LMConfig, *, tp_axis="model", fsdp_axis="data"):
    fs = fsdp_axis if cfg.fsdp else None
    lay = ((lambda *sp: P(None, *sp)) if cfg.scan_layers else
           (lambda *sp: P(*sp)))
    return [
        (r"embed/table", P(tp_axis, fs)),
        (r"lm_head/w", P(fs, tp_axis)),
        (r"w[qkv]/w", lay(fs, tp_axis)),
        (r"w[qkv]/b", lay(tp_axis)),
        (r"wo/w", lay(tp_axis, fs)),
        # expert parallelism: expert banks sharded over the expert axis
        (r"moe/w_(gate|up|down)", lay(tp_axis, fs, None)),
        (r"moe/router/w", lay(fs, None)),
        (r"moe/shared/w_(gate|up)/w", lay(fs, tp_axis)),
        (r"moe/shared/w_down/w", lay(tp_axis, fs)),
        (r"ln", P()),
    ]
