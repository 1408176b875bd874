"""Dense decoder-only transformer (GQA + RoPE + SwiGLU + RMSNorm):
glm4-9b, qwen1.5-110b (QKV bias), deepseek-67b, deepseek-coder-33b.
Counterpart of ``repro/models/dense.py``: serving, the training loss,
the partition rules (``partition_rules``: the reference's Megatron-style
TP plus FSDP over ``data``) and the Branch-Parallel layer
(``bp_parallel_layer``).

Parameters live in a :class:`DenseLM` under the reference's key paths
(``embed.table``, ``layers.<i>.wq.w``, ``layers.<i>.mlp.w_gate.w``,
``ln_f.scale``, ``lm_head.w``); the reference scans over a stacked layer
axis, which ``bridge`` splits across ``layers`` (``stacked=("layers",)``).

``prefill`` and ``decode_step`` write the new keys and values into the
cache's tensors in place and return the cache: the reference's functional
updates would copy the whole cache at every layer of every token.  Like the
reference's ``dynamic_update_slice``, a write at a position past the end of
the cache lands on its last slot.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.lmconfig import LMConfig
from repro_torch.nn.attention import attention, decode_attention
from repro_torch.nn.layers import (Dense, Embedding, Policy, RMSNorm, SwiGLU,
                                   dense, rmsnorm, swiglu, make_generator)
from repro_torch.nn.partition import P
from repro_torch.nn.rope import apply_rope

BF16 = Policy()


# ---------------------------------------------------------------------------
# init
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
        self.mlp = SwiGLU(d, cfg.d_ff, **kw)


class DenseLM(nn.Module):
    """All parameters, drawn on ``device`` (``cuda`` by default, raising
    without a card unless ``device="cpu"``) from a generator there seeded
    with ``seed``, one module at a time, each cast to ``dtype`` as soon as it
    is drawn: at bf16 the card holds at most one module (a layer, the
    embedding or the head) in fp32 besides the bf16 weights."""

    def __init__(self, cfg: LMConfig, *, seed: int = 0, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        device = resolve_device(device)
        g = make_generator(device, seed)
        kw = dict(generator=g, device=device)
        self.embed = Embedding(cfg.vocab, cfg.d_model, **kw).to(dtype)
        self.layers = nn.ModuleList(Layer(cfg, **kw).to(dtype)
                                    for _ in range(cfg.n_layer))
        self.ln_f = RMSNorm(cfg.d_model, device=device).to(dtype)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab, use_bias=False,
                                 **kw).to(dtype)


def init_params(cfg: LMConfig, *, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32) -> DenseLM:
    return DenseLM(cfg, seed=seed, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def attention_block(p: Layer, cfg: LMConfig, x, positions, *, causal=True,
                    kv_cache: Optional[tuple] = None, cache_lengths=None):
    """Returns (out, (k, v)): the new K/V for cache maintenance."""
    b, s, _ = x.shape
    h = rmsnorm(p.ln1, x)
    q = dense(p.wq, h).reshape(b, s, cfg.n_head, cfg.d_head)
    k = dense(p.wk, h).reshape(b, s, cfg.n_kv_head, cfg.d_head)
    v = dense(p.wv, h).reshape(b, s, cfg.n_kv_head, cfg.d_head)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    if kv_cache is not None:
        o = decode_attention(q, kv_cache[0], kv_cache[1], lengths=cache_lengths)
    else:
        o = attention(q, k, v, causal=causal, impl=cfg.attention_impl,
                      chunk_size=cfg.attention_chunk)
    o = dense(p.wo, o.reshape(b, s, cfg.n_head * cfg.d_head))
    return o, (k, v)


def layer_apply(p: Layer, cfg: LMConfig, x, positions, *, causal=True,
                kv_cache=None, cache_lengths=None):
    att, kv = attention_block(p, cfg, x, positions, causal=causal,
                              kv_cache=kv_cache, cache_lengths=cache_lengths)
    if cfg.parallel_block:
        # PaLM-style: x + Attn(LN1 x) + MLP(LN2 x), two independent branches
        mlp = swiglu(p.mlp, rmsnorm(p.ln2, x))
        return (x + att + mlp).to(att.dtype), kv
    x = x + att
    x = x + swiglu(p.mlp, rmsnorm(p.ln2, x))
    return x.to(att.dtype), kv


def bp_parallel_layer(p: Layer, cfg: LMConfig, x, positions, *, axis,
                      causal=True):
    """Branch-Parallel dense layer (the reference's ``bp_parallel_layer``):
    over ``axis`` (a ``mesh_utils.Axis`` of extent 2, the branch axis) the
    rank at coordinate 0 computes the attention branch and the rank at 1
    the MLP branch of a PaLM-style parallel block, and one all-reduce
    merges them (``parallel.branch.branch_parallel``).  Requires
    ``cfg.parallel_block``; returns (out, None), as ``layer_apply`` returns
    (out, kv) without the cache."""
    from repro_torch.parallel.branch import branch_parallel
    if not cfg.parallel_block:
        raise ValueError("BP on dense LMs requires parallel_block=True "
                         "(sequential blocks have a serial dependency)")

    def attn_branch():
        return (attention_block(p, cfg, x, positions, causal=causal)[0],)

    def mlp_branch():
        return (swiglu(p.mlp, rmsnorm(p.ln2, x)),)

    like = (x.new_empty(x.shape),)
    att, mlp = branch_parallel([attn_branch, mlp_branch], [like, like],
                               axis=axis)()
    return (x + att + mlp).to(x.dtype), None


def remat(cfg: LMConfig, fn):
    """``fn(layer, *args)`` under ``cfg.remat``: for ``"layer"``, while
    autograd records, one ``torch.utils.checkpoint`` a call (the
    reference's ``jax.checkpoint`` of its scanned layer body): the call
    keeps only its inputs, and the backward recomputes its forward.  A
    layer whose parameters a data-parallel step holds sharded
    (``parallel.fsdp``) is gathered inside the call, just before its use,
    so the recompute gathers it again."""
    from repro_torch.parallel import fsdp
    fn = fsdp.gathering(fn)
    if cfg.remat != "layer":
        return fn

    def ckpt(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # nothing in a layer draws from torch's generators
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return ckpt


def backbone(params: DenseLM, cfg: LMConfig, x, positions, *, causal=True):
    """Run the layer stack on embeddings x (B, S, D), each layer under
    :func:`remat`."""
    one = remat(cfg, lambda lp, x: layer_apply(lp, cfg, x, positions,
                                               causal=causal)[0])
    for lp in params.layers:
        x = one(lp, x)
    return rmsnorm(params.ln_f, x)


def logits_fn(params: DenseLM, cfg: LMConfig, x):
    head = getattr(params, "lm_head", None)
    if cfg.tie_embeddings or head is None:
        return x @ params.embed.table.to(x.dtype).T
    return dense(head, x)


def _positions(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def forward(params: DenseLM, cfg: LMConfig, tokens):
    """tokens (B, S) -> logits (B, S, V), in bf16 (the cast through
    autograd: gradients reach the fp32 masters)."""
    params = BF16.cast_train(params)
    b, s = tokens.shape
    x = params.embed.table[tokens.long()]
    x = backbone(params, cfg, x, _positions(b, s, x.device))
    return logits_fn(params, cfg, x)


def cross_entropy(logits, labels, *, mask=None):
    """Mean next-token negative log-likelihood: the log-sum-exp in fp32,
    the label's logit in the logits' dtype; with ``mask`` (B, S) the mean
    over its weight (at least 1)."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    label_logit = logits.gather(-1, labels.long()[..., None])[..., 0].float()
    nll = lse - label_logit
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def loss(params: DenseLM, cfg: LMConfig, batch: dict):
    logits = forward(params, cfg, batch["tokens"])
    return cross_entropy(logits, batch["labels"], mask=batch.get("mask"))


# ---------------------------------------------------------------------------
# serving: cache + prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    device = resolve_device(device)
    shape = (cfg.n_layer, batch, max_len, cfg.n_kv_head, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


@torch.no_grad()
def prefill(params: DenseLM, cfg: LMConfig, tokens, cache):
    """Fill the cache with the prompt tokens (B, S); returns (last-token
    logits (B, 1, V), cache)."""
    params = BF16.cast(params)
    b, s = tokens.shape
    x = params.embed.table[tokens.long()]
    positions = _positions(b, s, x.device)
    for i, lp in enumerate(params.layers):
        x, (k, v) = layer_apply(lp, cfg, x, positions, causal=True)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    x = rmsnorm(params.ln_f, x)
    logits = logits_fn(params, cfg, x[:, -1:])
    return logits, {"k": cache["k"], "v": cache["v"],
                    "length": torch.full((b,), s, dtype=torch.int32,
                                         device=x.device)}


def write_kv_cache(c, new, lengths, *, uniform: bool):
    """Write ``new`` (B, 1, KV, Hd) into the cache ``c`` (B, T, KV, Hd), in
    place, at each sequence's length, clamped to T - 1 as the reference's
    ``dynamic_update_slice`` clamps.  ``uniform=True`` writes every sequence
    at ``lengths[0]`` (the reference's uniform-length batch contract)."""
    last = c.shape[1] - 1
    if uniform:
        idx = lengths[:1].long().clamp(0, last)
        return c.index_copy_(1, idx, new.to(c.dtype))
    idx = lengths.long().clamp(0, last)
    rows = torch.arange(c.shape[0], device=c.device)
    c[rows, idx] = new[:, 0].to(c.dtype)
    return c


def decode_attention_block(p, cfg: LMConfig, h, kc, vc, length):
    """One token's attention in a decode step: ``h`` (B, 1, D) normalised,
    its keys and values written into the caches ``kc`` / ``vc`` (B, T, KV,
    Hd) in place at ``length`` (B,), then attention over each sequence's
    filled slots; returns ``wo`` of the output (B, 1, D).  ``p`` holds
    ``wq`` / ``wk`` / ``wv`` / ``wo`` (a layer, or the hybrid's shared
    block)."""
    b = h.shape[0]
    positions = length[:, None]                                  # (B, 1)
    q = dense(p.wq, h).reshape(b, 1, cfg.n_head, cfg.d_head)
    k = dense(p.wk, h).reshape(b, 1, cfg.n_kv_head, cfg.d_head)
    v = dense(p.wv, h).reshape(b, 1, cfg.n_kv_head, cfg.d_head)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    kc = write_kv_cache(kc, k, length, uniform=cfg.uniform_decode)
    vc = write_kv_cache(vc, v, length, uniform=cfg.uniform_decode)
    o = decode_attention(q, kc, vc, lengths=length + 1)
    return dense(p.wo, o.reshape(b, 1, cfg.n_head * cfg.d_head))


@torch.no_grad()
def decode_step(params: DenseLM, cfg: LMConfig, tokens1, cache):
    """One decode step: tokens1 (B, 1) -> (logits (B, 1, V), cache)."""
    params = BF16.cast(params)
    x = params.embed.table[tokens1.long()]
    length = cache["length"]
    for i, lp in enumerate(params.layers):
        att = decode_attention_block(lp, cfg, rmsnorm(lp.ln1, x),
                                     cache["k"][i], cache["v"][i], length)
        if cfg.parallel_block:
            x = x + att + swiglu(lp.mlp, rmsnorm(lp.ln2, x))
        else:
            x = x + att
            x = x + swiglu(lp.mlp, rmsnorm(lp.ln2, x))
        x = x.to(att.dtype)
    x = rmsnorm(params.ln_f, x)
    logits = logits_fn(params, cfg, x)
    return logits, {"k": cache["k"], "v": cache["v"], "length": length + 1}


# ---------------------------------------------------------------------------
# partitioning (TP over 'model'; optional FSDP over 'data')
# ---------------------------------------------------------------------------

def partition_rules(cfg: LMConfig, *, tp_axis="model", fsdp_axis="data"):
    """Megatron-style TP (heads / ffn / vocab) + optional ZeRO-3 FSDP over
    data, the reference's rules: written for the stacked layer layout
    (leading layer dim unsharded) when ``cfg.scan_layers``, which
    ``nn.partition.make_param_specs(stacked=...)`` maps onto the port's
    per-layer leaves."""
    fs = fsdp_axis if cfg.fsdp else None
    lay = ((lambda *sp: P(None, *sp)) if cfg.scan_layers else
           (lambda *sp: P(*sp)))
    return [
        (r"embed/table", P(tp_axis, fs)),
        (r"lm_head/w", P(fs, tp_axis)),
        (r"w[qkv]/w", lay(fs, tp_axis)),
        (r"w[qkv]/b", lay(tp_axis)),
        (r"wo/w", lay(tp_axis, fs)),
        (r"mlp/w_(gate|up)/w", lay(fs, tp_axis)),
        (r"mlp/w_down/w", lay(tp_axis, fs)),
        (r"ln", P()),
    ]
