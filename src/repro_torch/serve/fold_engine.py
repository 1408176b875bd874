"""FoldEngine: AF2 structure-prediction serving on one device (counterpart of
``repro/serve/fold_engine.py:37-286``).

Requests are padded onto a small bucket table; one fold step per bucket is
built on first use and cached (``compile_misses`` counts the misses, so the
step count is bounded by the table, never by traffic).  On the card a
bucket's step replays its sample-cycle as a CUDA graph, captured at the
step's first use (``graphs=``; the reference jit-compiles the step).
Requests of one bucket are micro-batched and recycled together under
``core.model.predict``'s early-exit loop: converged samples freeze, the
batch ends when all froze or ``max_recycle`` ran, and ``result.n_recycles``
records what each sample paid.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import graphs as graphs_lib
from repro_torch.core.config import with_kernels
from repro_torch.device import resolve_device
from repro_torch.nn.layers import Policy
from repro_torch.serve import fold_steps as fs


@dataclasses.dataclass
class FoldRequest:
    rid: int
    features: dict          # unpadded: msa_feat (s,r,f), extra_msa_feat,
    #                         target_feat (r,f), residue_index (r,)


@dataclasses.dataclass
class FoldResult:
    rid: int
    coords: np.ndarray      # (r, 3) CA positions
    plddt: np.ndarray       # (r,) confidence in [0, 100]
    contact_probs: np.ndarray   # (r, r) P(d_ij <= 8A)
    n_recycles: int         # trunk cycles this sample actually consumed
    converged: bool         # early-exited before max_recycle
    bucket: fs.Bucket
    latency_s: float        # wall time of the batched step that served it


class FoldEngine:
    """Queue-driven AF2 fold server over one model on one device.

    ``device`` defaults to ``cuda`` (raising without a card); the model is
    moved there and cast to ``dtype`` once, into ``params``, which every
    step reads.  Every attention and triangle update is served on the
    hand-written kernels (``config.with_kernels``), whatever impls ``cfg``
    names.  ``graphs``: capture each bucket's sample-cycle as a CUDA graph
    (``fold_steps.GraphedCycle``, all in one memory pool); None means on
    for a CUDA device and off on the CPU, True on the CPU raises
    ValueError.
    """

    def __init__(self, cfg, model, *, buckets=None, micro_batch: int = 2,
                 max_recycle: Optional[int] = None, tol: float = 0.0,
                 dtype=None, device=None, graphs: Optional[bool] = None):
        self.device = resolve_device(device)
        self.graphs = graphs_lib.use_graphs(graphs, self.device)
        self.cfg = with_kernels(cfg)
        self.dtype = dtype or torch.bfloat16
        self.params = Policy(compute_dtype=self.dtype).cast(
            model.to(self.device))
        self.buckets = sorted(buckets or fs.default_buckets(cfg))
        self.micro_batch = micro_batch
        self.max_recycle = max_recycle or cfg.max_recycle
        self.tol = tol
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self._steps: Dict[fs.Bucket, object] = {}
        self.compile_misses = 0                 # step-cache misses
        self.stats = {"requests": 0, "steps": 0, "recycles_run": 0,
                      "recycles_budget": 0, "per_bucket": {}}
        # deltas of the most recent run(): lifetime ratios drift as calls
        # accumulate, one call's efficiency is judged on these
        self.last_stats: dict = {}

    _SCALAR_STATS = ("requests", "steps", "recycles_run", "recycles_budget")

    def step_for(self, bucket: fs.Bucket):
        """The fold step of this bucket, built once and cached (with graphs,
        its first call captures the bucket's sample-cycle)."""
        if bucket not in self._steps:
            self.compile_misses += 1
            self._steps[bucket] = fs.make_fold_step(
                fs.bucket_cfg(self.cfg, bucket), max_recycle=self.max_recycle,
                tol=self.tol, dtype=self.dtype, graphs=self.graphs,
                pool=self._pool)
        return self._steps[bucket]

    def load_weights(self, model) -> None:
        """Serve ``model``'s weights from now on: copied into ``params`` in
        place, cast to its dtype, since the captured graphs read that
        storage."""
        with torch.no_grad():
            for dst, src in zip(self.params.parameters(), model.parameters(),
                                strict=True):
                dst.copy_(src)

    def run(self, requests: List[FoldRequest]) -> Dict[int, FoldResult]:
        """Serve the queue to completion; returns {rid: FoldResult}.

        FIFO with same-bucket skip-ahead: the head request picks the bucket,
        then up to micro_batch - 1 later requests of the same bucket ride
        along in its step.
        """
        queue = [(fs.bucket_for(self.buckets, r.features), r)
                 for r in requests]
        done: Dict[int, FoldResult] = {}
        snap = {k: self.stats[k] for k in self._SCALAR_STATS}
        try:
            while queue:
                bucket, head = queue.pop(0)
                group, rest = [head], []
                for b, req in queue:
                    if len(group) < self.micro_batch and b == bucket:
                        group.append(req)
                    else:
                        rest.append((b, req))
                queue = rest
                for req, res in zip(group, self._run_group(bucket, group)):
                    done[req.rid] = res
        finally:
            self.last_stats = {k: self.stats[k] - snap[k]
                               for k in self._SCALAR_STATS}
            budget = self.last_stats["recycles_budget"]
            self.last_stats["recycle_fraction"] = (
                self.last_stats["recycles_run"] / budget if budget else 0.0)
        return done

    def _run_group(self, bucket: fs.Bucket, group: List[FoldRequest]):
        padded = [fs.pad_to_bucket(r.features, bucket) for r in group]
        batch = fs.stack_padded(padded, self.micro_batch)
        active = np.arange(self.micro_batch) < len(group)
        step = self.step_for(bucket)
        t0 = time.perf_counter()
        out = step(self.params, batch, active)
        out = {k: v.float().cpu().numpy() if v.is_floating_point()
               else v.cpu().numpy() for k, v in out.items()}
        dt = time.perf_counter() - t0

        self.stats["requests"] += len(group)
        self.stats["steps"] += 1
        self.stats["recycles_run"] += int(out["n_recycles"][:len(group)].sum())
        self.stats["recycles_budget"] += self.max_recycle * len(group)
        pb = self.stats["per_bucket"].setdefault(
            bucket, {"requests": 0, "steps": 0, "seconds": 0.0})
        pb["requests"] += len(group)
        pb["steps"] += 1
        pb["seconds"] += dt

        results = []
        for i, req in enumerate(group):
            r = fs.request_shapes(req.features)[0]
            results.append(FoldResult(
                rid=req.rid,
                coords=out["coords"][i, :r],
                plddt=out["plddt"][i, :r],
                contact_probs=out["contact_probs"][i, :r, :r],
                n_recycles=int(out["n_recycles"][i]),
                converged=bool(out["converged"][i]),
                bucket=bucket,
                latency_s=dt))
        return results
