"""Zamba2-style hybrid (arXiv:2411.15242): counterpart of
``repro/models/hybrid.py``, the partition rules (``partition_rules``)
included.

A Mamba2 backbone (``ssm.Block``) plus one weight-SHARED attention block
applied after every layer i with ``i % shared_attn_every == 0``: it reads
concat(hidden, token embedding), projects it back to d_model (``fuse``),
then runs full attention and a SwiGLU MLP, and its output is added to the
hidden state.  Its weights are shared, but each invocation keeps a KV cache
of its own (``shared_k`` / ``shared_v``, one row per invocation: 14 for
zamba2-7b's 81 layers).  In decode the embedding it reads is the current
token's.  Its prefill attention goes through ``nn.attention.attention(
impl=cfg.attention_impl)``: on the kernels (``with_kernels``), the flash
kernel K6 at the config's head dim (112 for zamba2-7b).

Under tensor parallelism (``parallel.tensor``) the backbone is
``ssm``'s, and the shared block's ``fuse`` is column-parallel before the
column-parallel ``w[qkv]``: its output is gathered over ``model``
(``tensor.gather``) into the block's residual stream, then the block's
attention and MLP run as ``dense``'s do.

The reference's docstring names a ``bp_hybrid_layer``; the JAX package has
no such function, and nothing here stands for it.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import dense, ssm
from repro_torch.models.lmconfig import LMConfig
from repro_torch.nn.partition import P
from repro_torch.nn.layers import (Dense, Embedding, Policy, RMSNorm, SwiGLU,
                                   dense as dense_apply, drawn, rmsnorm,
                                   make_generator)
from repro_torch.parallel import tensor

BF16 = Policy()


def n_shared_invocations(cfg: LMConfig) -> int:
    every = cfg.shared_attn_every
    return (cfg.n_layer + every - 1) // every if every else 0


def shared_at(cfg: LMConfig, i: int) -> bool:
    """Whether the shared block runs after backbone layer ``i`` (its
    invocation is ``i // shared_attn_every``)."""
    return i % cfg.shared_attn_every == 0


class SharedBlock(nn.Module):
    def __init__(self, cfg: LMConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.d_head
        kw = dict(generator=generator, device=device)
        self.fuse = Dense(2 * d, d, use_bias=False, **kw)
        self.ln1 = RMSNorm(d, device=device)
        self.wq = Dense(d, cfg.n_head * hd, use_bias=False, **kw)
        self.wk = Dense(d, cfg.n_kv_head * hd, use_bias=False, **kw)
        self.wv = Dense(d, cfg.n_kv_head * hd, use_bias=False, **kw)
        self.wo = Dense(cfg.n_head * hd, d, use_bias=False, **kw)
        self.ln2 = RMSNorm(d, device=device)
        self.mlp = SwiGLU(d, cfg.d_ff, **kw)


def fuse(p: SharedBlock, cfg: LMConfig, x, x0):
    """``fuse`` of concat(x, x0), whole on every rank (column-parallel,
    then gathered, where ``fuse`` is split)."""
    xx = torch.cat([x, x0], dim=-1)
    if tensor.split_of(p.fuse.w.shape[-1], cfg.d_model, "fuse") is None:
        return dense_apply(p.fuse, xx)
    return tensor.gather(dense_apply(p.fuse, tensor.copy_in(xx)))


def shared_block_apply(p: SharedBlock, cfg: LMConfig, x, x0, positions,
                       cache=None):
    """x, x0 (B, S, D) -> (the update to add to x, (k, v)), causal over the
    S tokens (the reference's ``kv_cache=`` branch has no caller: decode
    runs ``decode_step``'s own); (k, v) as ``dense.attention_block``'s for
    a ``cache``."""
    h = fuse(p, cfg, x, x0)
    att, kv = dense.attention_block(p, cfg, h, positions, cache=cache)
    h = h + att
    h = h + dense.mlp(p.mlp, rmsnorm(p.ln2, h), cfg.d_ff)
    return h.to(x.dtype), kv


class HybridLM(nn.Module):
    """All parameters, drawn on ``device`` (``cuda`` by default, raising
    without a card unless ``device="cpu"``) from a generator there seeded
    with ``seed``, one module at a time, each cast to ``dtype`` as soon as
    it is drawn (as ``dense.DenseLM``).  ``shared`` is one block, not a
    stack."""

    def __init__(self, cfg: LMConfig, *, seed: int = 0, device=None,
                 dtype: torch.dtype = torch.float32, cut=None):
        super().__init__()
        device = resolve_device(device)
        g = make_generator(device, seed)
        kw = dict(generator=g, device=device)
        self.embed = drawn(Embedding(cfg.vocab, cfg.d_model, **kw), dtype,
                           cut, "embed.")
        self.layers = nn.ModuleList(
            drawn(ssm.Block(cfg, **kw), dtype, cut, f"layers.{i}.")
            for i in range(cfg.n_layer))
        self.shared = drawn(SharedBlock(cfg, **kw), dtype, cut, "shared.")
        self.ln_f = drawn(RMSNorm(cfg.d_model, device=device), dtype, cut,
                          "ln_f.")
        self.lm_head = drawn(Dense(cfg.d_model, cfg.vocab, use_bias=False,
                                   **kw), dtype, cut, "lm_head.")


def init_params(cfg: LMConfig, *, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32, cut=None) -> HybridLM:
    return HybridLM(cfg, seed=seed, device=device, dtype=dtype, cut=cut)


def backbone(params: HybridLM, cfg: LMConfig, x, positions):
    """The stack on token embeddings x (B, S, D) (also the shared block's
    x0), each layer with its shared-block invocation under
    ``dense.remat``, then ``ln_f``."""
    def one(lp, x, x0, shared: bool):
        x = (x + ssm.block_apply(lp, cfg, x)).to(x.dtype)
        if shared:
            upd, _ = shared_block_apply(params.shared, cfg, x, x0, positions)
            x = (x + upd).to(x.dtype)
        return x

    one = dense.remat(cfg, one)
    x0 = x
    for i, lp in enumerate(params.layers):
        x = one(lp, x, x0, shared_at(cfg, i))
    return rmsnorm(params.ln_f, x)


def forward(params: HybridLM, cfg: LMConfig, tokens):
    """tokens (B, S) -> logits (B, S, V), in bf16."""
    params = BF16.cast_train(params)
    b, s = tokens.shape
    x = dense.embed(params, cfg, tokens)
    x = backbone(params, cfg, x, dense._positions(b, s, x.device))
    return dense.logits_fn(params, cfg, x)


def loss(params: HybridLM, cfg: LMConfig, batch: dict):
    logits = forward(params, cfg, batch["tokens"])
    return tensor.cross_entropy(logits, batch["labels"], cfg.vocab,
                                mask=batch.get("mask"))


# ---------------------------------------------------------------------------
# serving: mamba states + per-invocation KV caches for the shared block
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    device = resolve_device(device)
    kv_shape = (n_shared_invocations(cfg), batch, max_len, cfg.n_kv_head,
                cfg.d_head)
    return {**ssm.init_cache(cfg, batch, max_len, dtype, device),
            "shared_k": torch.zeros(kv_shape, dtype=dtype, device=device),
            "shared_v": torch.zeros(kv_shape, dtype=dtype, device=device)}


@torch.no_grad()
def prefill(params: HybridLM, cfg: LMConfig, tokens, cache):
    """Fill the mamba states and each invocation's KV cache with the prompt
    tokens (B, S); returns (last-token logits (B, 1, V), cache)."""
    b, s = tokens.shape
    ssm.check_prompt(cfg, s)
    params = BF16.cast(params)
    x = dense.embed(params, cfg, tokens)
    x0 = x
    positions = dense._positions(b, s, x.device)
    every = cfg.shared_attn_every
    for i, lp in enumerate(params.layers):
        y, (conv_s, S) = ssm.mamba_with_state(lp, cfg, x)
        x = (x + y).to(x.dtype)
        cache["conv"][i] = conv_s
        cache["S"][i] = S
        if shared_at(cfg, i):
            upd, (k, v) = shared_block_apply(
                params.shared, cfg, x, x0, positions,
                cache=cache["shared_k"][i // every])
            cache["shared_k"][i // every, :, :s] = k
            cache["shared_v"][i // every, :, :s] = v
            x = (x + upd).to(x.dtype)
    x = rmsnorm(params.ln_f, x)
    logits = dense.logits_fn(params, cfg, x[:, -1:])
    return logits, {**cache, "length": torch.full((b,), s, dtype=torch.int32,
                                                  device=x.device)}


@torch.no_grad()
def decode_step(params: HybridLM, cfg: LMConfig, tokens1, cache):
    """One decode step: tokens1 (B, 1) -> (logits (B, 1, V), cache)."""
    params = BF16.cast(params)
    x = dense.embed(params, cfg, tokens1)[:, 0]          # (B, D)
    x0 = x
    length = cache["length"]
    every = cfg.shared_attn_every
    sp = params.shared
    for i, lp in enumerate(params.layers):
        y, st = ssm.block_decode(lp, cfg, x, {"conv": cache["conv"][i],
                                              "S": cache["S"][i]})
        x = (x + y).to(x.dtype)
        cache["conv"][i] = st["conv"]
        cache["S"][i] = st["S"]
        if not shared_at(cfg, i):
            continue
        h = fuse(sp, cfg, x, x0)[:, None]
        inv = i // every
        h = h + dense.decode_attention_block(
            sp, cfg, rmsnorm(sp.ln1, h), cache["shared_k"][inv],
            cache["shared_v"][inv], length)
        h = h + dense.mlp(sp.mlp, rmsnorm(sp.ln2, h), cfg.d_ff)
        x = (x + h[:, 0]).to(x.dtype)
    x = rmsnorm(params.ln_f, x)
    logits = dense.logits_fn(params, cfg, x[:, None])
    return logits, {**cache, "length": length + 1}


# ---------------------------------------------------------------------------
# partitioning: the shared block's rules, then the Mamba2 backbone's
# ---------------------------------------------------------------------------

def partition_rules(cfg: LMConfig, *, tp_axis="model", fsdp_axis="data"):
    fs = fsdp_axis if cfg.fsdp else None
    rules = ssm.partition_rules(cfg, tp_axis=tp_axis, fsdp_axis=fsdp_axis)
    shared = [
        (r"shared/fuse/w", P(fs, tp_axis)),
        (r"shared/w[qkv]/w", P(fs, tp_axis)),
        (r"shared/wo/w", P(tp_axis, fs)),
        (r"shared/mlp/w_(gate|up)/w", P(fs, tp_axis)),
        (r"shared/mlp/w_down/w", P(tp_axis, fs)),
        (r"shared/ln", P()),
    ]
    return shared + rules
