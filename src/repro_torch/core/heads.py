"""Prediction heads and confidence utilities (counterpart of
``repro/core/heads.py:14-86``; the training losses come with training)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.config import AlphaFold2Config
from repro_torch.nn.layers import Dense, LayerNorm, dense, layernorm


class PlddtHead(nn.Module):
    def __init__(self, c_s: int, n_bins: int, *, generator: torch.Generator):
        super().__init__()
        self.ln = LayerNorm(c_s)
        self.w1 = Dense(c_s, c_s, generator=generator)
        self.w2 = Dense(c_s, c_s, generator=generator)
        self.out = Dense(c_s, n_bins, generator=generator)


class Heads(nn.Module):
    def __init__(self, cfg: AlphaFold2Config, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.distogram = Dense(cfg.c_z, cfg.n_distogram_bins, generator=g)
        self.masked_msa = Dense(cfg.c_m, cfg.n_aatype, generator=g)
        self.plddt = PlddtHead(cfg.structure.c_s, cfg.n_plddt_bins, generator=g)


def distogram_logits(p: Heads, z: torch.Tensor) -> torch.Tensor:
    """(..., r, r, c_z) -> symmetrized (..., r, r, n_bins) logits."""
    half = dense(p.distogram, z)
    return half + half.transpose(-3, -2)


def plddt_logits(p: Heads, s: torch.Tensor) -> torch.Tensor:
    h = layernorm(p.plddt.ln, s)
    h = torch.relu(dense(p.plddt.w1, h))
    h = torch.relu(dense(p.plddt.w2, h))
    return dense(p.plddt.out, h)


def plddt_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """(..., n_bins) -> per-residue pLDDT in [0, 100]: the expected value over
    equal-width bins ordered by increasing lDDT."""
    nb = logits.shape[-1]
    centers = 100.0 * (torch.arange(nb, dtype=torch.float32,
                                    device=logits.device) + 0.5) / nb
    probs = torch.softmax(logits.float(), dim=-1)
    return probs @ centers


def contact_probs_from_distogram(logits: torch.Tensor, *, cutoff: float = 8.0,
                                 min_dist: float = 2.3125,
                                 max_dist: float = 21.6875) -> torch.Tensor:
    """(..., r, r, n_bins) -> P(d_ij <= cutoff): the mass of the bins whose
    upper edge (``linspace(min_dist, max_dist, n_bins - 1)``, then +inf) is
    at most ``cutoff``."""
    nb = logits.shape[-1]
    edges = torch.linspace(min_dist, max_dist, nb - 1, device=logits.device)
    upper = torch.cat([edges, torch.tensor([float("inf")], device=logits.device)])
    probs = torch.softmax(logits.float(), dim=-1)
    return (probs * (upper <= cutoff)).sum(-1)
