"""InternVL2-style VLM (arXiv:2404.16821): counterpart of
``repro/models/vlm.py``, the partition rules (``partition_rules``)
included.  The InternLM2 dense backbone (``models.dense``) with a ViT
frontend stub, as in the reference: the caller gives precomputed InternViT
patch features (B, P, frontend_dim); a two-layer projector (LayerNorm over
frontend_dim, ``w1``, tanh-GELU, ``w2``) maps them into the embedding space
and they are prepended to the tokens.

Parameters live in a :class:`VLM`: a ``dense.DenseLM`` plus ``projector``
(``projector.ln.scale``, ``projector.w1.w``, ``projector.w2.b``), which
``bridge`` carries across as it is.  ``prefill`` runs every layer's causal
attention over the P + S positions (K6 under ``with_kernels``) and writes
their K/V at offset 0 of the cache in place; decoding is dense's.

Under tensor parallelism (``parallel.tensor``) ``w1`` and ``w2`` are both
column-parallel: ``w1``'s output is gathered over ``model`` before
``w2``, and ``w2``'s into the whole embedding.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import dense
from repro_torch.models.lmconfig import LMConfig
from repro_torch.nn.partition import P
from repro_torch.parallel import tensor
from repro_torch.nn.layers import (Dense, LayerNorm, Policy, dense as linear,
                                   drawn, gelu, layernorm, rmsnorm,
                                   make_generator)

BF16 = Policy()


class Projector(nn.Module):
    def __init__(self, cfg: LMConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln = LayerNorm(cfg.frontend_dim, device=device)
        self.w1 = Dense(cfg.frontend_dim, cfg.d_model, **kw)
        self.w2 = Dense(cfg.d_model, cfg.d_model, **kw)


class VLM(dense.DenseLM):
    """The dense LM's parameters, then the projector's, drawn as
    ``dense.DenseLM`` draws them (one module at a time on ``device``, each
    cast to ``dtype``)."""

    def __init__(self, cfg: LMConfig, *, seed: int = 0, device=None,
                 dtype: torch.dtype = torch.float32, cut=None):
        super().__init__(cfg, seed=seed, device=device, dtype=dtype, cut=cut)
        device = self.embed.table.device
        g = make_generator(device, seed + 1)
        self.projector = drawn(Projector(cfg, generator=g, device=device),
                               dtype, cut, "projector.")


def init_params(cfg: LMConfig, *, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32, cut=None) -> VLM:
    return VLM(cfg, seed=seed, device=device, dtype=dtype, cut=cut)


def project_patches(params: VLM, patches):
    p = params.projector
    d = p.w2.w.shape[0]
    h = layernorm(p.ln, patches)
    for w in (p.w1, p.w2):
        if tensor.split_of(w.w.shape[-1], d, "projector") is None:
            h = linear(w, h)
        else:
            # the patches are bf16: promote before the input's all-reduce,
            # which then sums fp32 cotangents as the one-device product does
            h = h.to(torch.promote_types(h.dtype, w.w.dtype))
            h = tensor.gather(linear(w, tensor.copy_in(h)))
        if w is p.w1:
            h = gelu(h)
    return h


def _embed(params: VLM, cfg: LMConfig, batch: dict):
    """[projected patches, token embeddings] (B, P + S, D) and P."""
    img = project_patches(params, batch["patches"].to(torch.bfloat16))
    txt = dense.embed(params, cfg, batch["tokens"])
    return torch.cat([img, txt], dim=1), img.shape[1]


def forward(params: VLM, cfg: LMConfig, batch: dict):
    """batch: ``patches`` (B, P, frontend_dim) and ``tokens`` (B, S) ->
    logits (B, S, V) of the text positions, in bf16."""
    params = BF16.cast_train(params)
    x, n_img = _embed(params, cfg, batch)
    b, n = x.shape[:2]
    x = dense.backbone(params, cfg, x, dense._positions(b, n, x.device))
    return dense.logits_fn(params, cfg, x[:, n_img:])


def loss(params: VLM, cfg: LMConfig, batch: dict):
    logits = forward(params, cfg, batch)
    return tensor.cross_entropy(logits, batch["labels"], cfg.vocab,
                                mask=batch.get("mask"))


# serving: prefill consumes patches + prompt; decoding is dense's
init_cache = dense.init_cache
decode_step = dense.decode_step


@torch.no_grad()
def prefill(params: VLM, cfg: LMConfig, batch: dict, cache):
    """Fill the cache with the patches and prompt tokens of ``batch``;
    returns (last-position logits (B, 1, V), cache of length P + S)."""
    params = BF16.cast(params)
    x, _ = _embed(params, cfg, batch)
    b, n = x.shape[:2]
    positions = dense._positions(b, n, x.device)
    for i, lp in enumerate(params.layers):
        x, (k, v) = dense.layer_apply(lp, cfg, x, positions, causal=True,
                                      cache=cache["k"][i])
        cache["k"][i, :, :n] = k
        cache["v"][i, :, :n] = v
    x = rmsnorm(params.ln_f, x)
    logits = dense.logits_fn(params, cfg, x[:, -1:])
    return logits, {"k": cache["k"], "v": cache["v"],
                    "length": torch.full((b,), n, dtype=torch.int32,
                                         device=x.device)}


# ---------------------------------------------------------------------------
# partitioning: the projector's rules, then the dense backbone's
# ---------------------------------------------------------------------------

def partition_rules(cfg: LMConfig, *, tp_axis="model", fsdp_axis="data"):
    fs = fsdp_axis if cfg.fsdp else None
    return [
        (r"projector/w[12]/w", P(fs, tp_axis)),
        (r"projector/w[12]/b", P(tp_axis)),
        (r"projector/ln", P()),
    ] + dense.partition_rules(cfg, tp_axis=tp_axis, fsdp_axis=fsdp_axis)
