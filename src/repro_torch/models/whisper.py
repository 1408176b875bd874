"""Whisper-style encoder-decoder (arXiv:2212.04356), transformer backbone
only: counterpart of ``repro/models/whisper.py``, the partition rules
(``partition_rules``) included.  The conv audio frontend is a stub, as in
the reference: the caller gives precomputed frame embeddings (B, T_frames,
frontend_dim), projected to d_model by ``frame_proj`` only where
frontend_dim differs from it.

Encoder: bidirectional attention over the frames (sinusoidal positions,
K6 non-causal under ``with_kernels``).  Decoder: causal self-attention plus
cross-attention to the encoder's output, LayerNorm and a tanh-GELU MLP, the
embedding tied as the head.  Serving caches the decoder's self-attention
K/V and the (static) cross-attention K/V of every layer; ``prefill`` and
``decode_step`` write the cache's tensors in place.

Parameters live in a :class:`WhisperLM` under the reference's key paths
(``enc_layers.<i>.wq.w``, ``dec_layers.<i>.xk.w``, ``enc_ln.scale``,
``embed.table``); ``bridge`` splits the stacked ``enc_layers`` /
``dec_layers`` axes (``stacked=LM_STACKED``).

Two quirks of the reference are kept (ROADMAP "Reference caveats"): a
decode step adds the position embedding of ``cache["length"][0]``, slot
0's length, to every slot; and that position indexes a table of 8192 rows,
where JAX's gather clamps a larger index, so the port clamps it too.
``prefill`` consumes the prompt's first token only.

Under tensor parallelism (``parallel.tensor``) the self- and
cross-attention projections and ``mlp/w_in`` are column-parallel (their
biases split with them), ``[wx]o`` and ``mlp/w_out`` row-parallel with
their replicated biases added once, after the all-reduce
(``tensor.row_dense``); the tied embedding is vocab-parallel where
``model`` divides the vocabulary (whisper-medium's 51865 it does not).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.dense import remat, write_kv_cache
from repro_torch.models.lmconfig import LMConfig
from repro_torch.nn.attention import attention, decode_attention
from repro_torch.nn.partition import P
from repro_torch.nn.layers import (Dense, Embedding, GeluMLP, LayerNorm,
                                   Policy, dense, drawn, gelu, gelu_mlp,
                                   layernorm, make_generator)
from repro_torch.parallel import tensor

BF16 = Policy()
# rows of the decoder's position table (the reference's decode step)
MAX_POSITIONS = 8192


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class EncLayer(nn.Module):
    def __init__(self, cfg: LMConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.d_head
        kw = dict(generator=generator, device=device)
        self.ln1 = LayerNorm(d, device=device)
        self.wq = Dense(d, cfg.n_head * hd, **kw)
        self.wk = Dense(d, cfg.n_kv_head * hd, use_bias=False, **kw)
        self.wv = Dense(d, cfg.n_kv_head * hd, **kw)
        self.wo = Dense(cfg.n_head * hd, d, **kw)
        self.ln2 = LayerNorm(d, device=device)
        self.mlp = GeluMLP(d, cfg.d_ff, **kw)


class DecLayer(EncLayer):
    """An encoder layer plus the cross-attention ``ln_x``, ``xq``, ``xk``
    (no bias), ``xv``, ``xo``."""

    def __init__(self, cfg: LMConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__(cfg, generator=generator, device=device)
        d, hd = cfg.d_model, cfg.d_head
        kw = dict(generator=generator, device=device)
        self.ln_x = LayerNorm(d, device=device)
        self.xq = Dense(d, cfg.n_head * hd, **kw)
        self.xk = Dense(d, cfg.n_kv_head * hd, use_bias=False, **kw)
        self.xv = Dense(d, cfg.n_kv_head * hd, **kw)
        self.xo = Dense(cfg.n_head * hd, d, **kw)


class WhisperLM(nn.Module):
    """All parameters, drawn on ``device`` (``cuda`` by default, raising
    without a card unless ``device="cpu"``) from a generator there seeded
    with ``seed``, one module at a time, each cast to ``dtype`` as soon as it
    is drawn (as ``dense.DenseLM``)."""

    def __init__(self, cfg: LMConfig, *, seed: int = 0, device=None,
                 dtype: torch.dtype = torch.float32, cut=None):
        super().__init__()
        device = resolve_device(device)
        g = make_generator(device, seed)
        kw = dict(generator=g, device=device)
        self.enc_layers = nn.ModuleList(
            drawn(EncLayer(cfg, **kw), dtype, cut, f"enc_layers.{i}.")
            for i in range(cfg.n_enc_layer))
        self.enc_ln = drawn(LayerNorm(cfg.d_model, device=device), dtype,
                            cut, "enc_ln.")
        self.embed = drawn(Embedding(cfg.vocab, cfg.d_model, **kw), dtype,
                           cut, "embed.")
        self.dec_layers = nn.ModuleList(
            drawn(DecLayer(cfg, **kw), dtype, cut, f"dec_layers.{i}.")
            for i in range(cfg.n_layer))
        self.dec_ln = drawn(LayerNorm(cfg.d_model, device=device), dtype,
                            cut, "dec_ln.")
        if cfg.frontend_dim != cfg.d_model:   # stub features not at d_model
            self.frame_proj = drawn(Dense(cfg.frontend_dim, cfg.d_model,
                                          **kw), dtype, cut, "frame_proj.")


def init_params(cfg: LMConfig, *, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32, cut=None) -> WhisperLM:
    return WhisperLM(cfg, seed=seed, device=device, dtype=dtype, cut=cut)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _heads(p, cfg: LMConfig, prefix: str) -> tensor.Heads:
    return tensor.block_heads(p, cfg.n_head, cfg.n_kv_head, cfg.d_head,
                              prefix)


def _mha(p, cfg: LMConfig, xq, xkv, *, prefix: str, causal: bool):
    """Attention of ``xq`` (B, S, D) over ``xkv`` (B, T, D) through the
    projections ``<prefix>q`` ... ``<prefix>o``; returns (out, (k, v))."""
    hp = _heads(p, cfg, prefix)
    same = xkv is xq
    xq = hp.copy_in(xq)
    xkv = xq if same else hp.copy_in(xkv)
    q = hp.q(dense(getattr(p, prefix + "q"), xq))
    k = hp.kv(dense(getattr(p, prefix + "k"), xkv))
    v = hp.kv(dense(getattr(p, prefix + "v"), xkv))
    o = attention(q, k, v, causal=causal, impl=cfg.attention_impl,
                  chunk_size=cfg.attention_chunk)
    return hp.out(o, getattr(p, prefix + "o")), (k, v)


def mlp(p: GeluMLP, x, d_ff: int):
    """``gelu_mlp``, column- then row-parallel (its ``w_out`` bias once)."""
    if tensor.split_of(p.w_in.w.shape[-1], d_ff, "mlp/w_in") is None:
        return gelu_mlp(p, x)
    h = gelu(dense(p.w_in, tensor.copy_in(x)))
    return tensor.row_dense(p.w_out, h, d_ff, "mlp/w_out")


def _angles(pos, dim: int):
    """pos (..., 1) fp32 -> (..., dim // 2): pos / 10000^(2i / dim)."""
    i = torch.arange(dim // 2, dtype=torch.float32, device=pos.device)
    return pos / torch.pow(10000.0, 2 * i / dim)


def _sinusoid(length: int, dim: int, dtype, device=None):
    """(length, dim): [sin, cos] of the angles, concatenated (not
    interleaved), in fp32, then cast to ``dtype``."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    a = _angles(pos, dim)
    return torch.cat([torch.sin(a), torch.cos(a)], -1).to(dtype)


def encode(params: WhisperLM, cfg: LMConfig, frames):
    """frames (B, T_f, frontend_dim), precomputed frame embeddings (the
    conv stem's stub) -> (B, T_f, D)."""
    x = frames
    if hasattr(params, "frame_proj"):
        x = dense(params.frame_proj, x)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)[None]

    def one(lp, x):
        h = layernorm(lp.ln1, x)
        att, _ = _mha(lp, cfg, h, h, prefix="w", causal=False)
        x = x + att
        x = x + mlp(lp.mlp, layernorm(lp.ln2, x), cfg.d_ff)
        return x.to(att.dtype)

    one = remat(cfg, one)
    for lp in params.enc_layers:
        x = one(lp, x)
    return layernorm(params.enc_ln, x)


def decode_train(params: WhisperLM, cfg: LMConfig, tokens, enc_out):
    """Teacher-forced decoder: tokens (B, S) over ``enc_out`` (B, T_f, D)
    -> logits (B, S, V) through the tied head."""
    s = tokens.shape[1]
    x = tensor.embed(params.embed.table, tokens, cfg.vocab)
    x = x + _sinusoid(s, cfg.d_model, x.dtype, x.device)[None]

    def one(lp, x, enc_out):
        h = layernorm(lp.ln1, x)
        att, _ = _mha(lp, cfg, h, h, prefix="w", causal=True)
        x = x + att
        h = layernorm(lp.ln_x, x)
        xatt, _ = _mha(lp, cfg, h, enc_out, prefix="x", causal=False)
        x = x + xatt
        x = x + mlp(lp.mlp, layernorm(lp.ln2, x), cfg.d_ff)
        return x.to(att.dtype)

    one = remat(cfg, one)
    for lp in params.dec_layers:
        x = one(lp, x, enc_out)
    x = layernorm(params.dec_ln, x)
    return tensor.lm_logits(x, params.embed.table, cfg.vocab,
                            tied=True)                       # tied head


def forward(params: WhisperLM, cfg: LMConfig, batch: dict):
    """batch: ``frames`` (B, T_f, frontend_dim) and ``tokens`` (B, S) ->
    logits (B, S, V), in bf16."""
    params = BF16.cast_train(params)
    enc_out = encode(params, cfg, batch["frames"].to(torch.bfloat16))
    return decode_train(params, cfg, batch["tokens"], enc_out)


def loss(params: WhisperLM, cfg: LMConfig, batch: dict):
    logits = forward(params, cfg, batch)
    return tensor.cross_entropy(logits, batch["labels"], cfg.vocab,
                                mask=batch.get("mask"))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Self-attention ``k`` / ``v`` (L, B, max_len, KV, Hd), cross-attention
    ``xk`` / ``xv`` (L, B, n_frontend_tokens, KV, Hd) (written by
    ``prefill``'s encoder pass) and ``length`` (B,)."""
    device = resolve_device(device)
    kv = (cfg.n_layer, batch, max_len, cfg.n_kv_head, cfg.d_head)
    xkv = (cfg.n_layer, batch, cfg.n_frontend_tokens, cfg.n_kv_head,
           cfg.d_head)
    z = lambda shape: torch.zeros(shape, dtype=dtype, device=device)
    return {"k": z(kv), "v": z(kv), "xk": z(xkv), "xv": z(xkv),
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


@torch.no_grad()
def prefill(params: WhisperLM, cfg: LMConfig, batch: dict, cache):
    """Encode ``batch["frames"]``, write every decoder layer's cross K/V
    into the cache, then one decode step on the prompt's first token
    (``batch["tokens"][:, :1]``, a BOS; the rest of the prompt is ignored,
    as in the reference).  Returns (logits (B, 1, V), cache)."""
    params = BF16.cast(params)
    enc_out = encode(params, cfg, batch["frames"].to(torch.bfloat16))
    b, tf = enc_out.shape[:2]
    for i, lp in enumerate(params.dec_layers):
        hp = _heads(lp, cfg, "x")
        cache["xk"][i] = hp.for_cache(dense(lp.xk, enc_out), cache["xk"][i])
        cache["xv"][i] = hp.for_cache(dense(lp.xv, enc_out), cache["xv"][i])
    return decode_step(params, cfg, batch["tokens"][:, :1], cache)


def position_embedding(cfg: LMConfig, length, dtype):
    """The decoder's position row for slot 0's ``length`` (the reference's
    ``_sinusoid(8192, ...)[cache["length"][0]]``, its index clamped to the
    table as JAX's gather clamps it): (1, 1, D), computed on the device."""
    pos = torch.clamp(length[:1], max=MAX_POSITIONS - 1).float()[:, None]
    a = _angles(pos, cfg.d_model)
    return torch.cat([torch.sin(a), torch.cos(a)], -1).to(dtype)[None]


@torch.no_grad()
def decode_step(params: WhisperLM, cfg: LMConfig, tokens1, cache):
    """One decode step: tokens1 (B, 1) -> (logits (B, 1, V), cache)."""
    params = BF16.cast(params)
    x = tensor.embed(params.embed.table, tokens1, cfg.vocab)
    length = cache["length"]
    x = x + position_embedding(cfg, length, x.dtype)
    for i, lp in enumerate(params.dec_layers):
        hp = _heads(lp, cfg, "w")
        h = layernorm(lp.ln1, x)
        q = hp.q(dense(lp.wq, h))
        kc = write_kv_cache(cache["k"][i],
                            hp.for_cache(dense(lp.wk, h), cache["k"][i]),
                            length, uniform=cfg.uniform_decode)
        vc = write_kv_cache(cache["v"][i],
                            hp.for_cache(dense(lp.wv, h), cache["v"][i]),
                            length, uniform=cfg.uniform_decode)
        o = decode_attention(q, hp.from_cache(kc), hp.from_cache(vc),
                             lengths=length + 1)
        x = x + hp.out(o, lp.wo)
        hx = _heads(lp, cfg, "x")
        q = hx.q(dense(lp.xq, layernorm(lp.ln_x, x)))
        o = decode_attention(q, hx.from_cache(cache["xk"][i]),
                             hx.from_cache(cache["xv"][i]))
        x = x + hx.out(o, lp.xo)
        x = x + mlp(lp.mlp, layernorm(lp.ln2, x), cfg.d_ff)
        x = x.to(o.dtype)
    x = layernorm(params.dec_ln, x)
    logits = tensor.lm_logits(x, params.embed.table, cfg.vocab, tied=True)
    return logits, {**cache, "length": length + 1}


# ---------------------------------------------------------------------------
# partitioning
# ---------------------------------------------------------------------------

def partition_rules(cfg: LMConfig, *, tp_axis="model", fsdp_axis="data"):
    fs = fsdp_axis if cfg.fsdp else None
    lay = ((lambda *sp: P(None, *sp)) if cfg.scan_layers else
           (lambda *sp: P(*sp)))
    return [
        (r"embed/table", P(tp_axis, fs)),
        (r"[wx][qkv]/w", lay(fs, tp_axis)),
        (r"[wx][qkv]/b", lay(tp_axis)),
        (r"[wx]o/w", lay(tp_axis, fs)),
        (r"[wx]o/b", lay()),
        (r"mlp/w_in/w", lay(fs, tp_axis)),
        (r"mlp/w_in/b", lay(tp_axis)),
        (r"mlp/w_out/w", lay(tp_axis, fs)),
        (r"mlp/w_out/b", lay()),
        (r"ln", P()),
    ]
