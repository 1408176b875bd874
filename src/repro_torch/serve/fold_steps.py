"""Fold-serving substrate: bucket table, bucket padding, fold steps
(counterpart of ``repro/serve/fold_steps.py:26-133``, one device).

* a ``Bucket`` names one padded shape (n_res, n_seq, n_extra_seq); requests
  map onto the smallest covering bucket, so the step cache is bounded by the
  bucket table, never by traffic;
* ``pad_to_bucket`` pads a request's features and attaches the validity
  masks that ``core.model.predict`` threads through every cross-position op;
* ``make_fold_step`` builds the (model, batch) -> outputs step of one
  bucket; with ``graphs`` its sample-cycle is a CUDA graph
  (:class:`GraphedCycle`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import graphs as graphs_lib
from repro_torch.core import model as af2

# keys predict() returns, all with a leading batch axis
PREDICT_OUTPUT_KEYS = ("coords", "plddt", "contact_probs", "plddt_logits",
                       "distogram_logits", "n_recycles", "converged")

# feature keys a fold request must carry (unpadded, per protein)
REQUEST_FEATURE_KEYS = ("msa_feat", "extra_msa_feat", "target_feat",
                        "residue_index")


@dataclasses.dataclass(frozen=True, order=True)
class Bucket:
    """One padded shape: residue / MSA-row / extra-MSA-row pads, ordered
    lexicographically — the "smallest covering bucket" preference."""
    n_res: int
    n_seq: int
    n_extra_seq: int

    def covers(self, r: int, s: int, se: int) -> bool:
        return self.n_res >= r and self.n_seq >= s and self.n_extra_seq >= se

    def describe(self) -> str:
        return f"r<={self.n_res} s<={self.n_seq} se<={self.n_extra_seq}"


def default_buckets(cfg, *, fractions=(0.25, 0.5, 1.0)) -> list:
    """Geometric ladder off the config's full shapes; MSA pads stay full
    depth in all but the smallest bucket."""
    out = []
    for f in sorted(fractions):
        r = max(8, int(cfg.n_res * f))
        s = cfg.n_seq if f > min(fractions) else max(4, cfg.n_seq // 2)
        se = cfg.n_extra_seq if f > min(fractions) else max(
            4, cfg.n_extra_seq // 2)
        out.append(Bucket(r, s, se))
    return sorted(set(out))


def request_shapes(features: dict) -> tuple:
    """(r, s, se) of an unpadded request's feature dict."""
    return (features["target_feat"].shape[0], features["msa_feat"].shape[0],
            features["extra_msa_feat"].shape[0])


def bucket_for(buckets, features: dict) -> Bucket:
    """Smallest bucket covering the request; actionable error when none does."""
    r, s, se = request_shapes(features)
    for b in sorted(buckets):
        if b.covers(r, s, se):
            return b
    raise ValueError(
        f"no bucket covers a request with n_res={r} n_seq={s} "
        f"n_extra_seq={se}; bucket table: "
        f"{[b.describe() for b in sorted(buckets)]} — add a larger bucket "
        "to FoldEngine(buckets=...) or truncate the request's MSA")


def bucket_cfg(cfg, bucket: Bucket):
    """The model config of this bucket (shapes only differ)."""
    return dataclasses.replace(cfg, n_res=bucket.n_res, n_seq=bucket.n_seq,
                               n_extra_seq=bucket.n_extra_seq)


def pad_to_bucket(features: dict, bucket: Bucket) -> dict:
    """Pad one request's features to the bucket and attach the res /
    MSA-row / extra-row validity masks."""
    r, s, se = request_shapes(features)
    if not bucket.covers(r, s, se):
        raise ValueError(f"request ({r}, {s}, {se}) does not fit bucket "
                         f"{bucket.describe()}")
    pr, ps, pse = bucket.n_res - r, bucket.n_seq - s, bucket.n_extra_seq - se
    f = {k: np.asarray(features[k]) for k in REQUEST_FEATURE_KEYS}
    return {
        "msa_feat": np.pad(f["msa_feat"], ((0, ps), (0, pr), (0, 0))),
        "extra_msa_feat": np.pad(f["extra_msa_feat"],
                                 ((0, pse), (0, pr), (0, 0))),
        "target_feat": np.pad(f["target_feat"], ((0, pr), (0, 0))),
        "residue_index": np.pad(f["residue_index"], (0, pr)),
        "res_mask": np.pad(np.ones((r,), np.float32), (0, pr)),
        "msa_row_mask": np.pad(np.ones((s,), np.float32), (0, ps)),
        "extra_row_mask": np.pad(np.ones((se,), np.float32), (0, pse)),
    }


def stack_padded(samples: list, batch: int) -> dict:
    """Stack padded samples into a (batch, ...) dict, repeating the last
    sample to fill unused micro-batch slots (the fold step skips them)."""
    if not samples:
        raise ValueError("stack_padded needs at least one sample")
    if len(samples) > batch:
        raise ValueError(f"{len(samples)} samples > micro-batch {batch}")
    filled = samples + [samples[-1]] * (batch - len(samples))
    return {k: np.stack([smp[k] for smp in filled]) for k in filled[0]}


class GraphedCycle:
    """``core.model.sample_cycle`` of one bucket as a CUDA graph at batch 1
    (a ``graphs.CapturedStep`` in ``pool``), captured at the first call on
    the parameter module it is given and replayed for every sample-cycle
    after.  The graph reads that module's storage: a later call with
    another module raises (load new weights into it with ``copy_``)."""

    def __init__(self, cfg, *, dtype, pool=None):
        self.cfg, self.dtype = cfg, dtype
        self.step = graphs_lib.CapturedStep(self._cycle, pool=pool)
        self.params = self.keys = None

    def _cycle(self, *tensors):
        n = len(self.keys)
        return af2.sample_cycle(self.params, self.cfg,
                                dict(zip(self.keys, tensors[:n])),
                                tuple(tensors[n:]), dtype=self.dtype)

    def __call__(self, params, sample: dict, prev: tuple):
        if self.params is None:
            self.params, self.keys = params, sorted(sample)
        elif params is not self.params or sorted(sample) != self.keys:
            raise ValueError("this bucket's graph was captured on another "
                             "parameter module or feature set")
        return self.step(*(sample[k] for k in self.keys), *prev)


def make_fold_step(cfg, *, max_recycle: int, tol: float, dtype=None,
                   graphs: bool = False, pool=None):
    """The (model, batch, active) -> outputs step of one bucket-shaped
    ``cfg``: the whole fold (``predict``'s recycling loop) on the model's
    device; slots with ``active`` False (micro-batch filler) are skipped.
    With ``graphs`` every sample-cycle replays one :class:`GraphedCycle`
    (captured into ``pool``), and the model must already be in ``dtype``
    and the same module at every call; the freeze logic, the convergence
    test and the heads stay on the host's eager path."""
    dtype = dtype or torch.bfloat16
    cycle = GraphedCycle(cfg, dtype=dtype, pool=pool) if graphs else None

    def step(model, batch, active=None):
        return af2.predict(model, cfg, batch, max_recycle=max_recycle,
                           tol=tol, dtype=dtype, active=active, cycle=cycle)

    return step
