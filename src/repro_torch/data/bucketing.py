"""Length-bucketed deterministic shuffle schedule, and padding of training
records onto a bucket (counterpart of ``repro/data/bucketing.py``).

The pipeline's batch composition: which records ride in which step's batch,
and what padded shape that batch takes.  Buckets are the serving layer's
type (``serve.fold_steps.Bucket``), so training batches and ``FoldEngine``
buckets share one vocabulary of padded shapes.

The schedule is a pure function of (record lengths, bucket table, seed,
batch_size): ``plan_epoch(epoch)`` shuffles record indices with
``default_rng([seed, 0xB0CCE7, epoch])``, groups them by smallest covering
bucket, chunks each group into fixed-size batches (a trailing partial chunk
wraps around within its bucket, so no shape varies) and shuffles the batch
order.  ``BucketSchedule.batch_plan`` maps a GLOBAL step to its epoch and
slot, so a run resumed at ``start_step > 0`` sees a fresh run's stream.

``pad_record_to_bucket`` extends ``serve.fold_steps.pad_to_bucket`` (request
keys and validity masks) with the training truth keys: padded residues get
gap ids, no masked positions, identity frames and zero translations, and
every loss ignores them through ``res_mask`` and ``msa_mask_positions``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.data.ingest import GAP_ID
from repro_torch.serve import fold_steps as fs

Bucket = fs.Bucket   # shared shape vocabulary with the serving layer


def train_bucket(cfg) -> Bucket:
    """The single terminal bucket of a training config: its full shapes."""
    return Bucket(cfg.n_res, cfg.n_seq, cfg.n_extra_seq)


def length_bucket_table(cfg, *, fractions=(0.25, 0.5, 1.0)) -> List[Bucket]:
    """Residue-length ladder at full MSA depth: training batches always
    carry the config's (s, se) rows, so only n_res varies across cells
    (``serve.fold_steps.default_buckets`` also halves MSA rows for its
    smallest serving cell — training keeps depth to stay one-step-shaped
    per residue pad)."""
    return sorted({Bucket(max(8, int(cfg.n_res * f)), cfg.n_seq,
                          cfg.n_extra_seq) for f in sorted(fractions)})


def bucket_for_length(buckets: Sequence[Bucket], n_res: int) -> Bucket:
    for b in sorted(buckets):
        if b.n_res >= n_res:
            return b
    raise ValueError(
        f"no bucket covers a record with n_res={n_res}; bucket table: "
        f"{[b.describe() for b in sorted(buckets)]} — add a larger bucket "
        "or crop the record")


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """One scheduled batch: the bucket its tensors pad to and the source
    record indices occupying its rows (wrapped duplicates fill the tail of
    a bucket's last batch — shapes never vary)."""
    bucket: Bucket
    indices: tuple


class BucketSchedule:
    """Deterministic (seed, step) -> BatchPlan over a record-length table.

    ``lengths[i]`` is record i's residue count.  ``bucket_by_length=False``
    degenerates to a plain shuffled schedule over ONE terminal bucket —
    the schedule abstraction stays, the grouping work disappears.
    """

    def __init__(self, lengths: Sequence[int], buckets: Sequence[Bucket], *,
                 seed: int = 0, batch_size: int = 1,
                 bucket_by_length: bool = True):
        if not lengths:
            raise ValueError("BucketSchedule needs at least one record")
        self.lengths = list(int(x) for x in lengths)
        self.buckets = sorted(buckets)
        self.seed = abs(seed)
        self.batch_size = batch_size
        self.bucket_by_length = bucket_by_length
        terminal = self.buckets[-1]
        bad = [i for i, n in enumerate(self.lengths) if n > terminal.n_res]
        if bad:
            raise ValueError(
                f"records {bad[:4]}... exceed the largest bucket "
                f"({terminal.describe()}); extend the table or crop")
        self._assign = [
            bucket_for_length(self.buckets, n) if bucket_by_length
            else terminal for n in self.lengths]
        # batches per epoch is length-table-derived, epoch-independent:
        # each bucket contributes ceil(count / batch_size) fixed batches
        counts: dict = {}
        for b in self._assign:
            counts[b] = counts.get(b, 0) + 1
        self.per_epoch = sum(-(-c // batch_size) for c in counts.values())

    def plan_epoch(self, epoch: int) -> List[BatchPlan]:
        """All batches of one epoch, deterministically shuffled."""
        rng = np.random.default_rng([self.seed, 0xB0CCE7, epoch])
        order = rng.permutation(len(self.lengths))
        groups: dict = {}
        for i in order:
            groups.setdefault(self._assign[i], []).append(int(i))
        plans = []
        for bucket in sorted(groups):
            idxs = groups[bucket]
            for lo in range(0, len(idxs), self.batch_size):
                chunk = idxs[lo:lo + self.batch_size]
                while len(chunk) < self.batch_size:   # wrap within bucket
                    chunk.append(idxs[(lo + len(chunk)) % len(idxs)])
                plans.append(BatchPlan(bucket, tuple(chunk)))
        perm = rng.permutation(len(plans))
        return [plans[i] for i in perm]

    def batch_plan(self, step: int) -> BatchPlan:
        """Global step -> its epoch's slot (epochs tile indefinitely)."""
        epoch, slot = divmod(step, self.per_epoch)
        return self.plan_epoch(epoch)[slot]


# ---------------------------------------------------------------------------
# Padding full training records onto a bucket
# ---------------------------------------------------------------------------

def pad_record_to_bucket(feats: dict, bucket: Bucket) -> dict:
    """Pad one ``featurize_record`` dict to the bucket's shapes.

    Request keys + validity masks go through the serving layer's
    ``pad_to_bucket`` (one padding implementation, not two); truth keys are
    extended here: gap ids / False mask positions / identity rotations /
    zero translations in the pad, all excluded from losses by ``res_mask``
    and ``msa_mask_positions``.
    """
    r, s = feats["target_feat"].shape[0], feats["true_msa"].shape[0]
    out = fs.pad_to_bucket(
        {k: feats[k] for k in fs.REQUEST_FEATURE_KEYS}, bucket)
    pr, ps = bucket.n_res - r, bucket.n_seq - s
    out["true_msa"] = np.pad(feats["true_msa"], ((0, ps), (0, pr)),
                             constant_values=GAP_ID)
    out["msa_mask_positions"] = np.pad(
        np.asarray(feats["msa_mask_positions"], bool), ((0, ps), (0, pr)))
    rots = np.pad(np.asarray(feats["true_rots"], np.float32),
                  ((0, pr), (0, 0), (0, 0)))
    if pr:
        rots[r:] = np.eye(3, dtype=np.float32)   # orthonormal in the pad
    out["true_rots"] = rots
    out["true_trans"] = np.pad(np.asarray(feats["true_trans"], np.float32),
                               ((0, pr), (0, 0)))
    return out


def stack_batch(samples: List[dict]) -> dict:
    """Stack per-record padded dicts into one (batch, ...) numpy batch."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
