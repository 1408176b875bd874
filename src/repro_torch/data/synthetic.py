"""Synthetic fold requests in numpy (counterpart of the features of
``repro/data/protein.py::protein_sample`` and of
``repro/launch/serve.py::make_fold_requests``).

The reference draws with ``jax.random``, whose stream torch and numpy cannot
reproduce; these draw the same kinds of features, with the same shapes,
dtypes and distributions, from ``numpy.random.default_rng``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.fold_engine import FoldRequest


def _one_hot(idx: np.ndarray, n: int) -> np.ndarray:
    return np.eye(n, dtype=np.float32)[idx]


def fold_features(rng: np.random.Generator, cfg) -> dict:
    """Unpadded request features at ``cfg``'s (n_res, n_seq, n_extra_seq):
    msa_feat (s, r, f_m), extra_msa_feat (se, r, f_m), target_feat (r, f_t),
    residue_index (r,)."""
    s, se, r = cfg.n_seq, cfg.n_extra_seq, cfg.n_res
    true_msa = rng.integers(0, cfg.n_aatype - 1, (s, r))
    masked = rng.random((s, r)) < 0.15
    msa_feat = _one_hot(np.where(masked, cfg.n_aatype - 1, true_msa),
                        cfg.msa_feat_dim)
    msa_feat += 0.1 * rng.standard_normal(msa_feat.shape).astype(np.float32)
    extra = _one_hot(rng.integers(0, cfg.n_aatype - 1, (se, r)),
                     cfg.msa_feat_dim)
    return {
        "msa_feat": msa_feat,
        "extra_msa_feat": extra,
        "target_feat": _one_hot(true_msa[0] % 21, cfg.target_feat_dim),
        "residue_index": np.arange(r, dtype=np.int32),
    }


def make_fold_requests(cfg, n: int, seed: int = 0,
                       fracs=(0.3, 0.6, 1.0)) -> list:
    """Mixed-length queue: request i has ~fracs[i % len(fracs)] of the
    config's shapes, so a default bucket table sees >= 2 buckets."""
    reqs = []
    for i in range(n):
        f = fracs[i % len(fracs)]
        c = dataclasses.replace(
            cfg, n_res=max(4, int(cfg.n_res * f)),
            n_seq=max(2, int(cfg.n_seq * f)),
            n_extra_seq=max(2, int(cfg.n_extra_seq * f)))
        rng = np.random.default_rng([seed, i])
        reqs.append(FoldRequest(rid=i, features=fold_features(rng, c)))
    return reqs
