"""Synthetic protein training samples, deterministic in (seed, step, idx):
the numpy counterpart of ``repro/data/protein.py``.

Features have the AF2 shapes and dtypes of the reference's samples; the
structures are smooth random chains with 3.8 Å CA-CA steps and orthonormal
per-residue frames, so the FAPE and distogram losses are well-posed.  The
numbers come from ``numpy.random.default_rng`` and differ from the
reference's ``jax.random`` draws; the distributions are the same.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.config import AlphaFold2Config

# folded into every validation seed, so the held-out stream never meets a
# training step's samples
VAL_SALT = 0x7A11DA7A


def _one_hot(idx: np.ndarray, n: int) -> np.ndarray:
    return np.eye(n, dtype=np.float32)[idx]


def chain_coords(rng: np.random.Generator, n_res: int) -> np.ndarray:
    """Random smooth chain: unit steps, smoothed over 5 residues, 3.8 Å."""
    steps = rng.standard_normal((n_res, 3)).astype(np.float32)
    kernel = np.ones((5,), np.float32) / 5.0
    steps = np.stack([np.convolve(steps[:, i], kernel, mode="same")
                      for i in range(3)], -1)
    steps = steps / (np.linalg.norm(steps, axis=-1, keepdims=True) + 1e-6)
    return np.cumsum(3.8 * steps, axis=0).astype(np.float32)


def frames_from_coords(x: np.ndarray):
    """Gram-Schmidt frames from consecutive CA displacements, with a fixed
    fallback direction where the chain is locally straight."""
    nxt = np.concatenate([x[1:], x[-1:] + (x[-1:] - x[-2:-1])], 0)
    prv = np.concatenate([x[:1] - (x[1:2] - x[:1]), x[:-1]], 0)
    e1 = nxt - x
    e1 = e1 / (np.linalg.norm(e1, axis=-1, keepdims=True) + 1e-6)
    v2 = x - prv
    e2 = v2 - np.sum(v2 * e1, -1, keepdims=True) * e1
    n2 = np.linalg.norm(e2, axis=-1, keepdims=True)
    ref = np.where(np.abs(e1[..., :1]) < 0.9, np.array([1.0, 0.0, 0.0]),
                   np.array([0.0, 1.0, 0.0]))
    alt = ref - np.sum(ref * e1, -1, keepdims=True) * e1
    alt = alt / (np.linalg.norm(alt, axis=-1, keepdims=True) + 1e-9)
    e2 = np.where(n2 > 1e-3, e2 / (n2 + 1e-9), alt)
    e3 = np.cross(e1, e2)
    return np.stack([e1, e2, e3], axis=-1).astype(np.float32), x


def protein_sample(rng: np.random.Generator, cfg: AlphaFold2Config) -> dict:
    s, se, r = cfg.n_seq, cfg.n_extra_seq, cfg.n_res
    true_msa = rng.integers(0, cfg.n_aatype - 1, (s, r))
    mask_positions = rng.random((s, r)) < 0.15
    msa_feat = np.where(mask_positions[..., None],
                        _one_hot(np.full((s, r), cfg.n_aatype - 1),
                                 cfg.msa_feat_dim),
                        _one_hot(true_msa, cfg.msa_feat_dim))
    msa_feat = msa_feat + 0.1 * rng.standard_normal((s, r, cfg.msa_feat_dim))
    extra_msa_feat = _one_hot(rng.integers(0, cfg.n_aatype - 1, (se, r)),
                              cfg.msa_feat_dim)
    target_feat = _one_hot(true_msa[0] % 21, cfg.target_feat_dim)
    rots, trans = frames_from_coords(chain_coords(rng, r))
    return {
        "msa_feat": msa_feat.astype(np.float32),
        "extra_msa_feat": extra_msa_feat,
        "target_feat": target_feat,
        "residue_index": np.arange(r, dtype=np.int32),
        "res_mask": np.ones((r,), np.float32),
        "true_msa": true_msa.astype(np.int32),
        "msa_mask_positions": mask_positions,
        "true_rots": rots,
        "true_trans": trans,
    }


def protein_sample_spec(cfg: AlphaFold2Config) -> dict:
    """{feature: (shape, numpy dtype)} of :func:`protein_sample`, with no
    data drawn: what the dry run (``launch/dryrun.py``) makes its ``meta``
    batch from."""
    s, se, r = cfg.n_seq, cfg.n_extra_seq, cfg.n_res
    f32 = np.dtype(np.float32)
    return {
        "msa_feat": ((s, r, cfg.msa_feat_dim), f32),
        "extra_msa_feat": ((se, r, cfg.msa_feat_dim), f32),
        "target_feat": ((r, cfg.target_feat_dim), f32),
        "residue_index": ((r,), np.dtype(np.int32)),
        "res_mask": ((r,), f32),
        "true_msa": ((s, r), np.dtype(np.int32)),
        "msa_mask_positions": ((s, r), np.dtype(np.bool_)),
        "true_rots": ((r, 3, 3), f32),
        "true_trans": ((r, 3), f32),
    }


def protein_batch(seed: int, step: int, batch_size: int,
                  cfg: AlphaFold2Config, *, split: str = "train") -> dict:
    """Deterministic batch: sample i of step t is drawn from
    ``default_rng([seed, t, i])`` (``split="val"``: a disjoint stream with a
    fixed salt).  Arrays carry a leading batch axis."""
    if split not in ("train", "val"):
        raise ValueError(f"split must be 'train' or 'val', got {split!r}")
    salt = [VAL_SALT] if split == "val" else []
    samples = [protein_sample(np.random.default_rng([seed, step, i] + salt),
                              cfg) for i in range(batch_size)]
    return {k: np.stack([smp[k] for smp in samples]) for k in samples[0]}
