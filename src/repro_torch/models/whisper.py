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
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.dense import cross_entropy, remat, write_kv_cache
from repro_torch.models.lmconfig import LMConfig
from repro_torch.nn.attention import attention, decode_attention
from repro_torch.nn.partition import P
from repro_torch.nn.layers import (Dense, Embedding, GeluMLP, LayerNorm,
                                   Policy, dense, gelu_mlp, layernorm,
                                   make_generator)

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
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        device = resolve_device(device)
        g = make_generator(device, seed)
        kw = dict(generator=g, device=device)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, **kw).to(dtype)
                                        for _ in range(cfg.n_enc_layer))
        self.enc_ln = LayerNorm(cfg.d_model, device=device).to(dtype)
        self.embed = Embedding(cfg.vocab, cfg.d_model, **kw).to(dtype)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, **kw).to(dtype)
                                        for _ in range(cfg.n_layer))
        self.dec_ln = LayerNorm(cfg.d_model, device=device).to(dtype)
        if cfg.frontend_dim != cfg.d_model:   # stub features not at d_model
            self.frame_proj = Dense(cfg.frontend_dim, cfg.d_model,
                                    **kw).to(dtype)


def init_params(cfg: LMConfig, *, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32) -> WhisperLM:
    return WhisperLM(cfg, seed=seed, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _mha(p, cfg: LMConfig, xq, xkv, *, prefix: str, causal: bool):
    """Attention of ``xq`` (B, S, D) over ``xkv`` (B, T, D) through the
    projections ``<prefix>q`` ... ``<prefix>o``; returns (out, (k, v))."""
    b, s, _ = xq.shape
    t = xkv.shape[1]
    q = dense(getattr(p, prefix + "q"), xq).reshape(b, s, cfg.n_head,
                                                    cfg.d_head)
    k = dense(getattr(p, prefix + "k"), xkv).reshape(b, t, cfg.n_kv_head,
                                                     cfg.d_head)
    v = dense(getattr(p, prefix + "v"), xkv).reshape(b, t, cfg.n_kv_head,
                                                     cfg.d_head)
    o = attention(q, k, v, causal=causal, impl=cfg.attention_impl,
                  chunk_size=cfg.attention_chunk)
    o = dense(getattr(p, prefix + "o"), o.reshape(b, s, cfg.n_head * cfg.d_head))
    return o, (k, v)


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
        x = x + gelu_mlp(lp.mlp, layernorm(lp.ln2, x))
        return x.to(att.dtype)

    one = remat(cfg, one)
    for lp in params.enc_layers:
        x = one(lp, x)
    return layernorm(params.enc_ln, x)


def decode_train(params: WhisperLM, cfg: LMConfig, tokens, enc_out):
    """Teacher-forced decoder: tokens (B, S) over ``enc_out`` (B, T_f, D)
    -> logits (B, S, V) through the tied head."""
    s = tokens.shape[1]
    x = params.embed.table[tokens.long()]
    x = x + _sinusoid(s, cfg.d_model, x.dtype, x.device)[None]

    def one(lp, x, enc_out):
        h = layernorm(lp.ln1, x)
        att, _ = _mha(lp, cfg, h, h, prefix="w", causal=True)
        x = x + att
        h = layernorm(lp.ln_x, x)
        xatt, _ = _mha(lp, cfg, h, enc_out, prefix="x", causal=False)
        x = x + xatt
        x = x + gelu_mlp(lp.mlp, layernorm(lp.ln2, x))
        return x.to(att.dtype)

    one = remat(cfg, one)
    for lp in params.dec_layers:
        x = one(lp, x, enc_out)
    x = layernorm(params.dec_ln, x)
    return x @ params.embed.table.to(x.dtype).T            # tied head


def forward(params: WhisperLM, cfg: LMConfig, batch: dict):
    """batch: ``frames`` (B, T_f, frontend_dim) and ``tokens`` (B, S) ->
    logits (B, S, V), in bf16."""
    params = BF16.cast_train(params)
    enc_out = encode(params, cfg, batch["frames"].to(torch.bfloat16))
    return decode_train(params, cfg, batch["tokens"], enc_out)


def loss(params: WhisperLM, cfg: LMConfig, batch: dict):
    logits = forward(params, cfg, batch)
    return cross_entropy(logits, batch["labels"], mask=batch.get("mask"))


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
        k = dense(lp.xk, enc_out).reshape(b, tf, cfg.n_kv_head, cfg.d_head)
        v = dense(lp.xv, enc_out).reshape(b, tf, cfg.n_kv_head, cfg.d_head)
        cache["xk"][i] = k
        cache["xv"][i] = v
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
    b = tokens1.shape[0]
    x = params.embed.table[tokens1.long()]
    length = cache["length"]
    x = x + position_embedding(cfg, length, x.dtype)
    hq = lambda p, h, n: dense(p, h).reshape(b, 1, n, cfg.d_head)
    for i, lp in enumerate(params.dec_layers):
        h = layernorm(lp.ln1, x)
        q = hq(lp.wq, h, cfg.n_head)
        kc = write_kv_cache(cache["k"][i], hq(lp.wk, h, cfg.n_kv_head),
                            length, uniform=cfg.uniform_decode)
        vc = write_kv_cache(cache["v"][i], hq(lp.wv, h, cfg.n_kv_head),
                            length, uniform=cfg.uniform_decode)
        o = decode_attention(q, kc, vc, lengths=length + 1)
        x = x + dense(lp.wo, o.reshape(b, 1, cfg.n_head * cfg.d_head))
        q = hq(lp.xq, layernorm(lp.ln_x, x), cfg.n_head)
        o = decode_attention(q, cache["xk"][i], cache["xv"][i])
        x = x + dense(lp.xo, o.reshape(b, 1, cfg.n_head * cfg.d_head))
        x = x + gelu_mlp(lp.mlp, layernorm(lp.ln2, x))
        x = x.to(o.dtype)
    x = layernorm(params.dec_ln, x)
    logits = x @ params.embed.table.to(x.dtype).T
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
