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

Under tensor parallelism (``parallel.tensor.model_parallel``) the
parameters are this rank's slices: the attention blocks take their heads
from ``tensor.block_heads`` (local heads where the split falls on them,
else the gathered projections), the MLP is column- then row-parallel, the
embedding, head and cross entropy vocab-parallel; ``prefill`` and
``decode_step`` return logits over this rank's share of the vocabulary
(``tensor.full_vocab`` / ``tensor.greedy`` read them), and a cache holds
the KV heads its cache rule names.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.lmconfig import LMConfig
from repro_torch.nn.attention import attention, decode_attention
from repro_torch.nn.layers import (Dense, Embedding, Policy, RMSNorm, SwiGLU,
                                   dense, drawn, rmsnorm, swiglu,
                                   make_generator)
from repro_torch.nn.partition import P
from repro_torch.nn.rope import apply_rope
from repro_torch.parallel import tensor

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
    embedding or the head) in fp32 besides the bf16 weights.  With ``cut``
    (a rank's ``parallel.fsdp.Layout.cut``) each module is cut to the
    rank's slices as soon as it is drawn: the slices of the one-device
    model's weights, as every family's ``init_params`` takes it."""

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
        if not cfg.tie_embeddings:
            self.lm_head = drawn(Dense(cfg.d_model, cfg.vocab,
                                       use_bias=False, **kw), dtype, cut,
                                 "lm_head.")


def init_params(cfg: LMConfig, *, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32, cut=None) -> DenseLM:
    return DenseLM(cfg, seed=seed, device=device, dtype=dtype, cut=cut)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def heads_of(p, cfg: LMConfig) -> tensor.Heads:
    """The block's ``tensor.Heads`` plan (all heads, off tensor
    parallelism)."""
    return tensor.block_heads(p, cfg.n_head, cfg.n_kv_head, cfg.d_head)


def attention_block(p: Layer, cfg: LMConfig, x, positions, *, causal=True,
                    kv_cache: Optional[tuple] = None, cache_lengths=None,
                    cache=None):
    """Returns (out, (k, v)): the new K/V for cache maintenance; under
    tensor parallelism the K/V heads that the cache ``cache`` (a layer's k
    tensor: all heads, or this rank's) takes, or for None the computed
    heads'."""
    hp = heads_of(p, cfg)
    h = hp.copy_in(rmsnorm(p.ln1, x))
    # q, k, v in the reference's order: autograd sums their gradients into
    # h in that order (bf16: another order rounds otherwise)
    qp, kp, vp = dense(p.wq, h), dense(p.wk, h), dense(p.wv, h)
    q, k, v = hp.q(qp), hp.kv(kp), hp.kv(vp)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    if kv_cache is not None:
        o = decode_attention(q, hp.from_cache(kv_cache[0]),
                             hp.from_cache(kv_cache[1]), lengths=cache_lengths)
    else:
        o = attention(q, k, v, causal=causal, impl=cfg.attention_impl,
                      chunk_size=cfg.attention_chunk)
    o = hp.out(o, p.wo)
    if cache is not None and hp.split:
        k = apply_rope(hp.for_cache(kp, cache), positions,
                       theta=cfg.rope_theta)
        v = hp.for_cache(vp, cache)
    return o, (k, v)


def mlp(p: SwiGLU, x, d_ff: int):
    """The SwiGLU MLP, column- then row-parallel (``swiglu`` off tensor
    parallelism)."""
    if tensor.split_of(p.w_gate.w.shape[-1], d_ff, "mlp/w_gate") is None:
        return swiglu(p, x)
    x = tensor.copy_in(x)
    return tensor.row_dense(p.w_down, F.silu(dense(p.w_gate, x))
                            * dense(p.w_up, x), d_ff, "mlp/w_down")


def layer_apply(p: Layer, cfg: LMConfig, x, positions, *, causal=True,
                kv_cache=None, cache_lengths=None, cache=None):
    att, kv = attention_block(p, cfg, x, positions, causal=causal,
                              kv_cache=kv_cache, cache_lengths=cache_lengths,
                              cache=cache)
    if cfg.parallel_block:
        # PaLM-style: x + Attn(LN1 x) + MLP(LN2 x), two independent branches
        y = mlp(p.mlp, rmsnorm(p.ln2, x), cfg.d_ff)
        return (x + att + y).to(att.dtype), kv
    x = x + att
    x = x + mlp(p.mlp, rmsnorm(p.ln2, x), cfg.d_ff)
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
    """Logits over the vocabulary (this rank's share of it under tensor
    parallelism, where the head is split)."""
    head = getattr(params, "lm_head", None)
    if cfg.tie_embeddings or head is None:
        return tensor.lm_logits(x, params.embed.table, cfg.vocab, tied=True)
    return tensor.lm_logits(x, head.w, cfg.vocab)


def embed(params, cfg: LMConfig, tokens):
    """The token embeddings (a vocab-parallel lookup where the table is
    split)."""
    return tensor.embed(params.embed.table, tokens, cfg.vocab)


def _positions(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def forward(params: DenseLM, cfg: LMConfig, tokens):
    """tokens (B, S) -> logits (B, S, V), in bf16 (the cast through
    autograd: gradients reach the fp32 masters)."""
    params = BF16.cast_train(params)
    b, s = tokens.shape
    x = embed(params, cfg, tokens)
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
    return tensor.cross_entropy(logits, batch["labels"], cfg.vocab,
                                mask=batch.get("mask"))


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
    x = embed(params, cfg, tokens)
    positions = _positions(b, s, x.device)
    for i, lp in enumerate(params.layers):
        x, (k, v) = layer_apply(lp, cfg, x, positions, causal=True,
                                cache=cache["k"][i])
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
    positions = length[:, None]                                  # (B, 1)
    hp = heads_of(p, cfg)
    h = hp.copy_in(h)
    q = apply_rope(hp.q(dense(p.wq, h)), positions, theta=cfg.rope_theta)
    k = apply_rope(hp.for_cache(dense(p.wk, h), kc), positions,
                   theta=cfg.rope_theta)
    kc = write_kv_cache(kc, k, length, uniform=cfg.uniform_decode)
    vc = write_kv_cache(vc, hp.for_cache(dense(p.wv, h), vc), length,
                        uniform=cfg.uniform_decode)
    o = decode_attention(q, hp.from_cache(kc), hp.from_cache(vc),
                         lengths=length + 1)
    return hp.out(o, p.wo)


@torch.no_grad()
def decode_step(params: DenseLM, cfg: LMConfig, tokens1, cache):
    """One decode step: tokens1 (B, 1) -> (logits (B, 1, V), cache)."""
    params = BF16.cast(params)
    x = embed(params, cfg, tokens1)
    length = cache["length"]
    for i, lp in enumerate(params.layers):
        att = decode_attention_block(lp, cfg, rmsnorm(lp.ln1, x),
                                     cache["k"][i], cache["v"][i], length)
        if cfg.parallel_block:
            x = x + att + mlp(lp.mlp, rmsnorm(lp.ln2, x), cfg.d_ff)
        else:
            x = x + att
            x = x + mlp(lp.mlp, rmsnorm(lp.ln2, x), cfg.d_ff)
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
