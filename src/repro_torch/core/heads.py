"""Prediction heads, confidence utilities, lDDT-Cα and the training losses
(FAPE, distogram, masked-MSA, pLDDT); counterpart of
``repro/core/heads.py``."""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from repro_torch.core.config import AlphaFold2Config
from repro_torch.core.structure import rigid_invert_apply
from repro_torch.nn.layers import Dense, LayerNorm, dense, layernorm, one_hot


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


def masked_msa_logits(p: Heads, msa: torch.Tensor) -> torch.Tensor:
    return dense(p.masked_msa, msa)


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
    upper = torch.cat([edges, torch.full((1,), float("inf"),
                                         device=logits.device)])
    probs = torch.softmax(logits.float(), dim=-1)
    return (probs * (upper <= cutoff)).sum(-1)


# ---------------------------------------------------------------------------
# lDDT-Cα (validation metric AND the pLDDT training target)
# ---------------------------------------------------------------------------

def lddt_ca(pred_coords, true_coords, res_mask, *, cutoff: float = 15.0,
            per_residue: bool = False) -> torch.Tensor:
    """Superposition-free lDDT over CA atoms, in [0, 100]: pairs i != j with
    true distance < ``cutoff`` score the fraction of the thresholds
    (0.5 / 1 / 2 / 4 Å) their distance error stays under.  ``per_residue``
    gives the (r,) profile, else one scalar over all scored pairs."""
    pc, tc, m = pred_coords.float(), true_coords.float(), res_mask.float()
    dp = torch.sqrt((pc[:, None] - pc[None, :]).square().sum(-1) + 1e-10)
    dt = torch.sqrt((tc[:, None] - tc[None, :]).square().sum(-1) + 1e-10)
    eye = torch.eye(dt.shape[0], device=dt.device)
    scored = (dt < cutoff).float() * m[:, None] * m[None, :] * (1.0 - eye)
    l1 = (dt - dp).abs()
    frac = 0.25 * sum((l1 < t).float() for t in (0.5, 1.0, 2.0, 4.0))
    dims = (1,) if per_residue else (0, 1)
    return 100.0 * ((scored * frac).sum(dims)
                    / torch.clamp(scored.sum(dims), min=1e-10))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def softmax_xent(logits, labels_onehot, mask):
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = (labels_onehot * logp).sum(-1)
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def fape_loss(pred_rots, pred_trans, true_rots, true_trans, res_mask, *,
              clamp: float = 10.0, scale: float = 10.0) -> torch.Tensor:
    """Frame-aligned point error over CA atoms (trans as the point cloud);
    frames with a leading trajectory axis are averaged over it."""
    if pred_rots.dim() == 3:
        pred_rots, pred_trans = pred_rots[None], pred_trans[None]
    x_local = rigid_invert_apply(pred_rots[:, :, None], pred_trans[:, :, None],
                                 pred_trans[:, None, :])        # (T, r, r, 3)
    x_true = rigid_invert_apply(true_rots[:, None], true_trans[:, None],
                                true_trans[None, :])
    err = torch.sqrt((x_local - x_true).square().sum(-1) + 1e-8)
    err = torch.clamp(err, 0.0, clamp) / scale
    m2 = res_mask[:, None] * res_mask[None, :]
    per_iter = (err * m2).sum((1, 2)) / torch.clamp(m2.sum(), min=1.0)
    return per_iter.mean()


@functools.lru_cache(maxsize=None)
def distogram_edges(n_bins: int, min_dist: float, max_dist: float,
                    device: torch.device) -> torch.Tensor:
    """The fp32 edges of the reference's ``jnp.linspace(min_dist, max_dist,
    n_bins - 1)`` (torch.linspace may round one apart) on ``device``, made
    once: inside a captured CUDA graph a copy from host memory is not
    allowed."""
    return torch.from_numpy(np.linspace(min_dist, max_dist, n_bins - 1)
                            .astype(np.float32)).to(device)


def distogram_loss(logits, true_coords, res_mask, *, n_bins: int,
                   min_dist: float = 2.3125, max_dist: float = 21.6875):
    d = torch.sqrt((true_coords[:, None] - true_coords[None, :]).square().sum(-1)
                   + 1e-8)
    edges = distogram_edges(n_bins, min_dist, max_dist, d.device)
    bins = (d[..., None] > edges).sum(-1)                   # (r, r) in [0, n_bins)
    onehot = one_hot(bins, n_bins).float()
    return softmax_xent(logits, onehot, res_mask[:, None] * res_mask[None, :])


def masked_msa_loss(logits, true_msa, mask_positions):
    onehot = one_hot(true_msa.long(), logits.shape[-1]).float()
    return softmax_xent(logits, onehot, mask_positions)


def plddt_loss(logits, pred_trans, true_coords, res_mask, *, n_bins: int):
    """The confidence head learns the binned per-residue lDDT-Cα of the
    final structure; the target is detached (bins ascend with lDDT, as
    :func:`plddt_from_logits` decodes them)."""
    lddt = lddt_ca(pred_trans, true_coords, res_mask, per_residue=True).detach()
    bins = torch.clamp((lddt / 100.0 * n_bins).to(torch.int64), 0, n_bins - 1)
    return softmax_xent(logits, one_hot(bins, n_bins).float(), res_mask)
