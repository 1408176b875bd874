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

The reference's docstring names a ``bp_hybrid_layer``; the JAX package has
no such function, and nothing here stands for it.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import dense, ssm
from repro_torch.models.lmconfig import LMConfig
from repro_torch.nn.attention import attention
from repro_torch.nn.partition import P
from repro_torch.nn.layers import (Dense, Embedding, Policy, RMSNorm, SwiGLU,
                                   dense as dense_apply, rmsnorm, swiglu,
                                   make_generator)
from repro_torch.nn.rope import apply_rope

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


def shared_block_apply(p: SharedBlock, cfg: LMConfig, x, x0, positions):
    """x, x0 (B, S, D) -> (the update to add to x, (k, v)), causal over the
    S tokens (the reference's ``kv_cache=`` branch has no caller: decode
    runs ``decode_step``'s own)."""
    b, s, _ = x.shape
    h = dense_apply(p.fuse, torch.cat([x, x0], dim=-1))
    hn = rmsnorm(p.ln1, h)
    q = dense_apply(p.wq, hn).reshape(b, s, cfg.n_head, cfg.d_head)
    k = dense_apply(p.wk, hn).reshape(b, s, cfg.n_kv_head, cfg.d_head)
    v = dense_apply(p.wv, hn).reshape(b, s, cfg.n_kv_head, cfg.d_head)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    o = attention(q, k, v, causal=True, impl=cfg.attention_impl,
                  chunk_size=cfg.attention_chunk)
    h = h + dense_apply(p.wo, o.reshape(b, s, cfg.n_head * cfg.d_head))
    h = h + swiglu(p.mlp, rmsnorm(p.ln2, h))
    return h.to(x.dtype), (k, v)


class HybridLM(nn.Module):
    """All parameters, drawn on ``device`` (``cuda`` by default, raising
    without a card unless ``device="cpu"``) from a generator there seeded
    with ``seed``, one module at a time, each cast to ``dtype`` as soon as
    it is drawn (as ``dense.DenseLM``).  ``shared`` is one block, not a
    stack."""

    def __init__(self, cfg: LMConfig, *, seed: int = 0, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        device = resolve_device(device)
        g = make_generator(device, seed)
        kw = dict(generator=g, device=device)
        self.embed = Embedding(cfg.vocab, cfg.d_model, **kw).to(dtype)
        self.layers = nn.ModuleList(ssm.Block(cfg, **kw).to(dtype)
                                    for _ in range(cfg.n_layer))
        self.shared = SharedBlock(cfg, **kw).to(dtype)
        self.ln_f = RMSNorm(cfg.d_model, device=device).to(dtype)
        self.lm_head = Dense(cfg.d_model, cfg.vocab, use_bias=False,
                             **kw).to(dtype)


def init_params(cfg: LMConfig, *, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32) -> HybridLM:
    return HybridLM(cfg, seed=seed, device=device, dtype=dtype)


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
    x = params.embed.table[tokens.long()]
    x = backbone(params, cfg, x, dense._positions(b, s, x.device))
    return dense_apply(params.lm_head, x)


def loss(params: HybridLM, cfg: LMConfig, batch: dict):
    logits = forward(params, cfg, batch["tokens"])
    return dense.cross_entropy(logits, batch["labels"],
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
    x = params.embed.table[tokens.long()]
    x0 = x
    positions = dense._positions(b, s, x.device)
    every = cfg.shared_attn_every
    for i, lp in enumerate(params.layers):
        y, (conv_s, S) = ssm.mamba_with_state(lp, cfg, x)
        x = (x + y).to(x.dtype)
        cache["conv"][i] = conv_s
        cache["S"][i] = S
        if shared_at(cfg, i):
            upd, (k, v) = shared_block_apply(params.shared, cfg, x, x0,
                                             positions)
            cache["shared_k"][i // every, :, :s] = k
            cache["shared_v"][i // every, :, :s] = v
            x = (x + upd).to(x.dtype)
    x = rmsnorm(params.ln_f, x)
    logits = dense_apply(params.lm_head, x[:, -1:])
    return logits, {**cache, "length": torch.full((b,), s, dtype=torch.int32,
                                                  device=x.device)}


@torch.no_grad()
def decode_step(params: HybridLM, cfg: LMConfig, tokens1, cache):
    """One decode step: tokens1 (B, 1) -> (logits (B, 1, V), cache)."""
    params = BF16.cast(params)
    x = params.embed.table[tokens1.long()][:, 0]         # (B, D)
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
        h = dense_apply(sp.fuse, torch.cat([x, x0], dim=-1))[:, None]
        inv = i // every
        h = h + dense.decode_attention_block(
            sp, cfg, rmsnorm(sp.ln1, h), cache["shared_k"][inv],
            cache["shared_v"][inv], length)
        h = h + swiglu(sp.mlp, rmsnorm(sp.ln2, h))
        x = (x + h[:, 0]).to(x.dtype)
    x = rmsnorm(params.ln_f, x)
    logits = dense_apply(params.lm_head, x[:, None])
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
