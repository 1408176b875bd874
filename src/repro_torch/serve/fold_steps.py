"""Fold-serving substrate: bucket table, bucket padding, fold steps and
the stepwise recycle step (counterpart of ``repro/serve/fold_steps.py``).

* a ``Bucket`` names one padded shape (n_res, n_seq, n_extra_seq); requests
  map onto the smallest covering bucket, so the step cache is bounded by the
  bucket table, never by traffic;
* ``pad_to_bucket`` pads a request's features and attaches the validity
  masks that ``core.model.predict`` threads through every cross-position op;
* ``make_fold_step`` builds the (model, batch) -> outputs step of one
  bucket, under an inference plan's ``BuiltPlan`` (each data-parallel
  replica folds its rows, the trunk runs the plan's DAP ``block_fn``, the
  outputs are gathered to every rank); on the card its sample-cycle is a
  CUDA graph (:class:`GraphedCycle`, :func:`make_cycle`);
* ``make_recycle_step`` builds the (model, batch, carry) -> (carry',
  outputs) step of continuous batching: one recycling cycle of every
  active slot, on the same ``core.model.fold_cycle`` and the same
  :class:`GraphedCycle` as the fold step, with the carry kept on the device
  (``init_recycle_carry``, ``clear_carry_slot``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import graphs as graphs_lib
from repro_torch.core import model as af2
from repro_torch.nn.layers import Policy
from repro_torch.parallel import collectives as coll

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

    def __init__(self, cfg, *, dtype, pool=None, block_fn=None, stack_io=None):
        self.cfg, self.dtype = cfg, dtype
        self.block_fn, self.stack_io = block_fn, stack_io
        self.step = graphs_lib.CapturedStep(self._cycle, pool=pool)
        self.params = self.keys = None

    def _cycle(self, *tensors):
        n = len(self.keys)
        return af2.sample_cycle(self.params, self.cfg,
                                dict(zip(self.keys, tensors[:n])),
                                tuple(tensors[n:]), dtype=self.dtype,
                                block_fn=self.block_fn,
                                stack_io=self.stack_io)

    def __call__(self, params, sample: dict, prev: tuple):
        if self.params is None:
            self.params, self.keys = params, sorted(sample)
        elif params is not self.params or sorted(sample) != self.keys:
            raise ValueError("this bucket's graph was captured on another "
                             "parameter module or feature set")
        return self.step(*(sample[k] for k in self.keys), *prev)


def make_cycle(cfg, built=None, *, dtype, graphs: bool, pool=None):
    """The sample-cycle a bucket's steps replay (their ``cycle``): with
    ``graphs`` one :class:`GraphedCycle` (under ``built``'s block_fn /
    stack_io, captured into ``pool``), which a bucket's fold and recycle
    steps share; else None (``fold_cycle`` runs ``sample_cycle``
    eagerly)."""
    if not graphs:
        return None
    return GraphedCycle(cfg, dtype=dtype, pool=pool,
                        block_fn=built.block_fn if built is not None else None,
                        stack_io=built.stack_io if built is not None else None)


def _gather_out(out: dict, dps) -> dict:
    """Every replica's rows of each tensor of ``out`` on every rank (gloo
    gathers no bool tensors: they travel as uint8)."""
    return {k: (coll.gather_rows(v.to(torch.uint8), dps).bool()
                if v.dtype == torch.bool else coll.gather_rows(v, dps))
            for k, v in out.items()}


def make_fold_step(cfg, built=None, *, max_recycle: int, tol: float,
                   dtype=None, cycle=None):
    """The (model, batch, active) -> outputs step of one bucket-shaped
    ``cfg``: the whole fold (``predict``'s recycling loop) on the model's
    device; slots with ``active`` False (micro-batch filler) are skipped.
    ``built``: an inference plan's ``BuiltPlan`` (None: one device) — each
    data-parallel replica folds its rows of the batch (a multiple of the
    data extent), through the plan's ``block_fn`` / ``stack_io``, and every
    output is gathered back to the whole batch on every rank.  With a
    ``cycle`` (:func:`make_cycle`: a :class:`GraphedCycle`) every
    sample-cycle replays it, and the model must already be in ``dtype``
    and the same module at every call; the freeze logic, the convergence
    test and the heads stay on the host's eager path."""
    dtype = dtype or torch.bfloat16
    block_fn = built.block_fn if built is not None else None
    stack_io = built.stack_io if built is not None else None
    dps = [built.axis(a) for a in built.dp_axes] if built is not None else []

    def fold(model, batch, active):
        return af2.predict(model, cfg, batch, max_recycle=max_recycle,
                           tol=tol, dtype=dtype, active=active, cycle=cycle,
                           block_fn=block_fn, stack_io=stack_io)

    def step(model, batch, active=None):
        if coll.axes_size(dps) == 1:
            return fold(model, batch, active)
        rows = built.local_rows(batch["target_feat"].shape[0])
        out = fold(model, {k: v[rows] for k, v in batch.items()},
                   None if active is None else active[rows])
        return _gather_out(out, dps)

    return step


# ---------------------------------------------------------------------------
# Stepwise recycling: the continuous-batching substrate
# ---------------------------------------------------------------------------

# the recycling carry of one bucket lane, one slot per batch row
RECYCLE_CARRY_KEYS = ("msa0", "z", "x", "sf", "conv", "n_rec", "active")


def init_recycle_carry(cfg, batch: int, device, dtype=torch.bfloat16) -> dict:
    """A fresh carry of ``batch`` free slots on ``device``, for the
    bucket-shaped ``cfg`` (:func:`bucket_cfg`).  msa0, z and sf are in the
    compute ``dtype`` and x in fp32, as ``fold_cycle`` produces them (the
    reference keeps them in fp32 on the host, which holds every bf16
    value exactly: the same values).  A slot with ``active`` False is
    inert under :func:`make_recycle_step`, so a zeroed slot plus an
    ``active`` flip is the whole admission protocol."""
    (msa0, z, x), sf = af2.fold_carry_init(cfg, batch, cfg.n_res, dtype,
                                           device)
    return {"msa0": msa0, "z": z, "x": x, "sf": sf,
            "conv": torch.zeros((batch,), dtype=torch.bool, device=device),
            "n_rec": torch.zeros((batch,), dtype=torch.int32, device=device),
            "active": torch.zeros((batch,), dtype=torch.bool, device=device)}


def clear_carry_slot(carry: dict, j: int) -> None:
    """Zero slot ``j`` of ``carry`` in place, on its device (admission and
    harvest)."""
    for k in RECYCLE_CARRY_KEYS:
        carry[k][j] = 0


def make_recycle_step(cfg, built=None, *, tol: float, dtype=None,
                      cycle=None):
    """The ``(model, batch, carry) -> (carry', outputs)`` step of one
    bucket-shaped ``cfg``: ONE recycling cycle of every active slot, with
    :func:`make_fold_step`'s freeze and convergence rules (both call
    ``core.model.fold_cycle``, so they cannot drift apart), then the heads
    over the carry, so any slot can be harvested the moment it converges.
    ``batch`` and ``carry`` are tensors on the model's device, ``carry'``
    may share their storage (the step consumes its carry).  Inactive slots
    never run, so writing a request's features into a free slot between
    steps cannot perturb the slots in flight.

    ``cycle`` as for :func:`make_fold_step`.  Under ``built`` (an
    inference plan's ``BuiltPlan``) each data-parallel replica steps its
    rows of the batch (a multiple of the data extent) through the plan's
    ``block_fn`` / ``stack_io``; the outputs and the ``conv`` / ``n_rec``
    flags are gathered to every rank, so every rank sees every slot (the
    large carry tensors of another replica's rows are left as they
    were)."""
    dtype = dtype or torch.bfloat16
    block_fn = built.block_fn if built is not None else None
    stack_io = built.stack_io if built is not None else None
    dps = [built.axis(a) for a in built.dp_axes] if built is not None else []

    def advance(params, batch, carry):
        pair_mask, pair_count = af2.fold_pair_mask(batch)
        prev, sf, conv, n_rec = af2.fold_cycle(
            params, cfg, batch, (carry["msa0"], carry["z"], carry["x"]),
            carry["sf"], carry["conv"], carry["n_rec"], tol=tol,
            pair_mask=pair_mask, pair_count=pair_count, dtype=dtype,
            active=carry["active"], cycle=cycle, block_fn=block_fn,
            stack_io=stack_io)
        out = af2.fold_heads(params, cfg, prev[1], sf)
        out.update(coords=prev[2], n_recycles=n_rec, converged=conv)
        new = {"msa0": prev[0], "z": prev[1], "x": prev[2], "sf": sf,
               "conv": conv, "n_rec": n_rec, "active": carry["active"]}
        return new, out

    @torch.no_grad()
    def step(model, batch, carry):
        params = Policy(compute_dtype=dtype).cast(model)
        if coll.axes_size(dps) == 1:
            return advance(params, batch, carry)
        rows = built.local_rows(batch["target_feat"].shape[0])
        new, out = advance(params, {k: v[rows] for k, v in batch.items()},
                           {k: v[rows] for k, v in carry.items()})
        for k in ("msa0", "z", "x", "sf"):
            carry[k][rows] = new[k]
        flags = _gather_out({"conv": new["conv"], "n_rec": new["n_rec"]},
                            dps)
        carry.update(flags)
        return carry, _gather_out(out, dps)

    return step
