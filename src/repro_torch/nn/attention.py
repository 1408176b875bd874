"""Attention for the LM zoo: the naive reference, the chunked online-softmax
path and the dispatcher onto the kernels (counterpart of
``repro/nn/attention.py``).

Impls, as in the reference:

* ``'reference'`` — naive O(S*T) softmax, the numerical oracle;
* ``'chunked'``   — online softmax over KV chunks in plain PyTorch (the LM
  configs' default; pure XLA in the reference);
* ``'pallas'``    — the hand-written kernels: causal / plain GQA goes to the
  LM flash kernel K6 (``kernels.ops.flash_attention``), biased non-causal
  self-attention to the Evoformer kernel K1 without its gate
  (``kernels.ops.evo_attention_nogate``).  ``mask=`` and ``q_offset=`` are
  rejected, as the reference rejects them.

Layouts: q (..., S, H, D); k/v (..., T, KV, D) with H = KV * G.  Masks and
bias broadcast to (..., H, S, T).  Softmax statistics are fp32.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _expand_gqa(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(..., S, H, D) -> (..., S, KV, G, D)."""
    *lead, s, h, d = q.shape
    if h % kv_heads:
        raise ValueError(f"{h} q heads not divisible by {kv_heads} kv heads")
    return q.reshape(*lead, s, kv_heads, h // kv_heads, d)


def attention_reference(q, k, v, *, causal: bool = False,
                        bias: Optional[torch.Tensor] = None,
                        mask: Optional[torch.Tensor] = None,
                        q_offset: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Naive O(S*T) attention.  The scores are computed in the inputs' dtype
    and then taken to fp32, the probabilities rounded to v's dtype for the
    product with v, as the reference's einsums do."""
    *_, s, h, d = q.shape
    t, kv = k.shape[-3], k.shape[-2]
    scale = scale if scale is not None else d ** -0.5
    qg = _expand_gqa(q, kv)                                   # (..., S, KV, G, D)
    logits = torch.einsum("...skgd,...tkd->...kgst", qg, k).float() * scale
    lead = logits.shape[:-4]
    logits = logits.reshape(*lead, h, s, t)
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    if causal:
        qpos = torch.arange(s, device=q.device) + q_offset
        cmask = qpos[:, None] >= torch.arange(t, device=q.device)[None, :]
        logits = torch.where(cmask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = probs.reshape(*lead, kv, h // kv, s, t).to(v.dtype)
    out = torch.einsum("...kgst,...tkd->...skgd", probs, v)
    return out.reshape(*lead, s, h, d)


def attention_chunked(q, k, v, *, causal: bool = False,
                      bias: Optional[torch.Tensor] = None,
                      mask: Optional[torch.Tensor] = None,
                      q_offset: int = 0,
                      scale: Optional[float] = None,
                      chunk_size: int = 1024) -> torch.Tensor:
    """Flash-style online-softmax attention over KV chunks.

    Never materialises the (S, T) score matrix; peak temporary is
    O(S * chunk).  ``mask`` may be 1-D (T,) key validity or broadcastable to
    (..., H, S, T); ``bias`` is chunked along T on its own shape (a trailing
    dim of 1 broadcasts over every chunk)."""
    *lead, s, h, d = q.shape
    t0, kv = k.shape[-3], k.shape[-2]
    g = h // kv
    scale = scale if scale is not None else d ** -0.5
    chunk_size = min(chunk_size, t0)
    n_chunks = -(-t0 // chunk_size)
    t = n_chunks * chunk_size
    dev = q.device
    key_valid = torch.arange(t, device=dev) < t0
    if mask is not None and mask.dim() == 1:
        key_valid = key_valid & torch.cat(
            [mask, mask.new_zeros((t - t0,))])
        mask = None
    if t != t0:
        pad = [0, 0, 0, 0, 0, t - t0]
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)

    qg = _expand_gqa(q, kv) * torch.tensor(scale, dtype=q.dtype)   # (..., S, KV, G, D)
    bias_f = None
    if bias is not None:
        bias_f = bias.float()
        if bias_f.shape[-1] != 1:
            if bias_f.shape[-1] != t0:
                raise ValueError(
                    f"bias trailing dim {bias_f.shape[-1]} must be 1 or match "
                    f"the key length {t0} (bias shape {tuple(bias.shape)})")
            bias_f = torch.nn.functional.pad(bias_f, [0, t - t0])
    if mask is not None:
        mask = torch.nn.functional.pad(
            torch.broadcast_to(mask, (*lead, h, s, t0)), [0, t - t0],
            value=False)
    qpos = torch.arange(s, device=dev) + q_offset

    m = torch.full((*lead, h, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((*lead, h, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((*lead, kv, g, s, d), dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        sl = slice(i * chunk_size, (i + 1) * chunk_size)
        kc, vc = k[..., sl, :, :], v[..., sl, :, :]
        logits = torch.einsum("...skgd,...tkd->...kgst", qg, kc).float()
        logits = logits.reshape(*lead, h, s, chunk_size)
        if bias_f is not None:
            logits = logits + (bias_f if bias_f.shape[-1] == 1
                               else bias_f[..., sl])
        valid = key_valid[sl]                                    # (chunk,)
        if causal:
            kpos = torch.arange(i * chunk_size, (i + 1) * chunk_size,
                                device=dev)
            valid = valid & (qpos[:, None] >= kpos[None, :])     # (s, chunk)
        if mask is not None:
            valid = valid & mask[..., sl]
        logits = torch.where(valid, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        p = torch.where(valid, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pg = p.reshape(*lead, kv, g, s, chunk_size).to(vc.dtype)
        upd = torch.einsum("...kgst,...tkd->...kgsd", pg, vc).float()
        acc = acc * corr.reshape(*lead, kv, g, s, 1) + upd
        m = m_new
    out = acc / torch.clamp(l.reshape(*lead, kv, g, s)[..., None], min=1e-30)
    out = torch.movedim(out, -2, -4)                         # (..., S, KV, G, D)
    return out.reshape(*lead, s, h, d).to(q.dtype)


def attention(q, k, v, *, impl: str = "chunked", chunk_size: int = 1024,
              **kw):
    """Dispatch: 'reference' | 'chunked' | 'pallas' (the kernels).

    ``impl='pallas'``: causal / plain GQA goes to K6; biased non-causal
    self-attention goes to K1 without a gate.  Unsupported combinations
    raise ``ValueError`` instead of failing inside a kernel."""
    if impl == "reference":
        return attention_reference(q, k, v, **kw)
    if impl == "chunked":
        return attention_chunked(q, k, v, chunk_size=chunk_size, **kw)
    if impl == "pallas":
        from repro_torch.kernels import ops
        bias = kw.pop("bias", None)
        mask = kw.pop("mask", None)
        causal = kw.pop("causal", False)
        q_offset = kw.pop("q_offset", 0)
        scale = kw.pop("scale", None)
        if kw:
            raise TypeError(
                f"impl='pallas' got unsupported kwargs {sorted(kw)}")
        if mask is not None:
            raise ValueError(
                "impl='pallas' does not support mask=; use impl='chunked' "
                "or fold the mask into an additive bias")
        if q_offset:
            raise ValueError("impl='pallas' does not support q_offset=")
        if bias is not None:
            if causal:
                raise ValueError(
                    "impl='pallas' supports bias= only for non-causal "
                    "self-attention (the Evoformer kernel); causal+bias "
                    "needs impl='chunked'")
            *lead, s, h, d = q.shape
            if k.shape != q.shape or v.shape != q.shape:
                raise ValueError(
                    "impl='pallas' with bias= requires self-attention with "
                    f"h == kv heads; got q {tuple(q.shape)} vs k "
                    f"{tuple(k.shape)}")
            if tuple(bias.shape) != (h, s, s):
                raise ValueError(
                    f"impl='pallas' bias must be (h, s, s)=({h}, {s}, {s}); "
                    f"got {tuple(bias.shape)} — broadcastable biases need "
                    "impl='chunked'")
            flat = lambda x: x.reshape(-1, s, h, d)
            out = ops.evo_attention_nogate(flat(q), flat(k), flat(v), bias,
                                           scale)
            return out.reshape(*lead, s, h, d)
        return ops.flash_attention(q, k, v, causal, scale)
    raise ValueError(f"unknown attention impl {impl!r}")


def decode_attention(q1, k_cache, v_cache, *, lengths=None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode: q1 (..., 1, H, D) against a (..., T, KV, D) cache.
    ``lengths`` (...,) is how many cache slots each sequence has filled."""
    mask = None
    if lengths is not None:
        t = k_cache.shape[-3]
        mask = torch.arange(t, device=k_cache.device) < lengths[..., None]
        mask = mask[..., None, None, :]                  # (..., 1, 1, T)
    return attention_reference(q1, k_cache, v_cache, mask=mask, scale=scale)
