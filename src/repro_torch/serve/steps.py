"""Serving steps on one device: prefill and single-token decode
(counterpart of ``repro/serve/steps.py``; the cache-sharding rules come with
tensor parallelism)."""
from __future__ import annotations

from repro_torch.models.lmconfig import LMConfig


def make_serve_step(model, cfg: LMConfig):
    """decode: (params, tokens (B, 1), cache) -> (logits, cache)."""
    def serve_step(params, tokens1, cache):
        return model.decode_step(params, cfg, tokens1, cache)
    return serve_step


def make_prefill_step(model, cfg: LMConfig):
    def prefill_step(params, batch, cache):
        return model.prefill(params, cfg, batch, cache)
    return prefill_step
