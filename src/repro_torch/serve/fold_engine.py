"""FoldEngine: AF2 structure-prediction serving (counterpart of
``repro/serve/fold_engine.py``), on one device or under inference
``ParallelPlan``s over rank processes.

Requests are padded onto a small bucket table; the steps of a (kind,
bucket, plan) cell are built on first use and cached (``compile_misses``
counts the misses: at most one per bucket and kind, never more as traffic
grows).  Two kinds: "fold", the whole fold (``run``), and "recycle", one
recycling cycle (``serve``).  On the card a bucket's sample-cycle is one
CUDA graph, captured at its first use and shared by both kinds
(``graphs=``; the reference jit-compiles each step).

* ``run`` drains a queue FIFO: requests of one bucket are micro-batched
  and recycled together under ``core.model.predict``'s early-exit loop;
  converged samples freeze, the batch ends when all froze or
  ``max_recycle`` ran, ``result.n_recycles`` records what each paid.
* ``serve`` takes requests arriving over virtual time (``arrival_s``,
  ``deadline_s``, ``priority``) and admits each into its bucket's next
  recycle step (``serve/scheduler.py::ContinuousScheduler``), with the
  featurize stage on host threads and a ``ResultCache``.
* Buckets of at least ``long_threshold`` residues run under ``long_plan``
  (typically DAP: the pair activations shard over the dap ranks), the
  others under ``plan``; both are normalised with ``for_inference()``.
  Every cell is validated against its bucket before it is built.

Telemetry as the reference's (``obs``, ``tracer``): ``stats`` and the
registry's ``serve/*`` counters change together through ``bump`` /
``bump_bucket``; each ``run`` / ``serve`` records a ``serve/call`` event,
``serve`` its report (``serve/report`` and the ``serve/report/*`` gauges);
``run``'s batched steps are ``fold_step`` spans, the scheduler's
``admit`` / ``recycle_step`` / ``harvest``.

Under a plan of several ranks every rank runs the engine on the same
requests and must take the same scheduling decisions, or the collectives
diverge and hang.  The reference is one controller and needs neither of
two rules here: ``serve`` agrees the virtual clock's step cost across all
the engine's ranks, whatever the stepped bucket's plan (the max of their
walls, one all-reduce a step, unless ``step_cost`` is injected), and
refuses ``featurize_workers > 0``, whose thread timing would differ from
rank to rank.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import graphs as graphs_lib
from repro_torch.core.config import with_kernels
from repro_torch.device import resolve_device
from repro_torch.nn.layers import Policy
from repro_torch.obs import MetricRegistry, trace_span
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import mesh_utils
from repro_torch.parallel.plan import BuiltPlan, ParallelPlan, as_plan
from repro_torch.serve import fold_steps as fs


@dataclasses.dataclass
class FoldRequest:
    rid: int
    features: dict          # unpadded: msa_feat (s,r,f), extra_msa_feat,
    #                         target_feat (r,f), residue_index (r,)
    # -- sustained traffic (serve(); run() ignores them) ----------------------
    arrival_s: float = 0.0              # virtual arrival instant
    deadline_s: Optional[float] = None  # absolute virtual deadline, or None
    priority: int = 0                   # higher is served first


@dataclasses.dataclass
class FoldResult:
    rid: int
    coords: np.ndarray      # (r, 3) CA positions
    plddt: np.ndarray       # (r,) confidence in [0, 100]
    contact_probs: np.ndarray   # (r, r) P(d_ij <= 8A)
    n_recycles: int         # trunk cycles this sample actually consumed
    converged: bool         # early-exited before max_recycle
    bucket: fs.Bucket
    latency_s: float        # run(): wall time of the batched step that
    #                         served it; serve(): virtual arrival -> finish
    # -- serve() only: virtual seconds, but featurize_s (host wall) ---------
    featurize_s: float = 0.0    # in the featurize stage
    queue_s: float = 0.0        # featurized -> admitted into a slot
    service_s: float = 0.0      # admitted -> harvested
    finish_s: float = 0.0       # virtual completion instant
    cache_hit: bool = False     # answered from the result cache


class FoldEngine:
    """AF2 fold server over one model.

    ``device`` defaults to ``cuda`` (raising without a card); the model is
    moved there and cast to ``dtype`` once, into ``params`` (a copy of its
    own), which every step reads.  Every attention and triangle update is
    served on the hand-written kernels (``config.with_kernels``), whatever
    impls ``cfg`` names.  ``graphs``: capture each bucket's sample-cycle as a CUDA graph
    (``fold_steps.GraphedCycle``, all in one memory pool); None means on
    for a CUDA device and off on the CPU, True on the CPU raises
    ValueError (and off / raising under a gloo plan of several ranks on a
    card, whose collectives a graph cannot capture).

    ``plan`` / ``long_plan``: ``ParallelPlan``s (training-shaped plans are
    accepted: ``for_inference()`` is applied); None is one device, and
    ``long_plan`` None is ``plan``.  Buckets of at least ``long_threshold``
    residues (default: the largest bucket's) run under ``long_plan``.
    Every rank of the plans runs the engine on the same requests; each
    data-parallel replica folds its rows of each micro-batch (rounded up
    to the data extent) and every rank gets every result.  ``ranks``: the
    global ranks the plans' meshes span (None: the whole world).

    ``obs``: a ``MetricRegistry`` (None: one without sinks); ``tracer``: a
    ``SpanTracer`` (None: the process's, if any).
    """

    def __init__(self, cfg, model, *, buckets=None, plan=None, long_plan=None,
                 long_threshold: Optional[int] = None, ranks=None,
                 micro_batch: int = 2, max_recycle: Optional[int] = None,
                 tol: float = 0.0, dtype=None, device=None,
                 graphs: Optional[bool] = None, obs=None, tracer=None):
        self.device = resolve_device(device)
        self.ranks = ranks
        self.plan = as_plan(plan).for_inference()
        self.long_plan = (as_plan(long_plan).for_inference()
                          if long_plan is not None else self.plan)
        self._built: Dict[ParallelPlan, BuiltPlan] = {}
        self._world = None      # agree_wall's mesh over all the ranks
        self.multi_rank = max(self.plan.n_devices,
                              self.long_plan.n_devices) > 1
        # without a process group the plans cannot be built (their build
        # raises PlanError); the engine's routing can still be inspected
        self.graphs = graphs_lib.use_graphs(
            graphs, self.device,
            collectives=(dist.get_backend() if self.multi_rank
                         and dist.is_initialized() else None))
        self.cfg = with_kernels(cfg)
        self.dtype = dtype or torch.bfloat16
        model = model.to(self.device)
        params = Policy(compute_dtype=self.dtype).cast(model)
        # the engine owns its storage: load_weights writes into it
        self.params = copy.deepcopy(model) if params is model else params
        self.buckets = sorted(buckets or fs.default_buckets(cfg))
        self.long_threshold = (long_threshold if long_threshold is not None
                               else self.buckets[-1].n_res)
        self.micro_batch = micro_batch
        self.max_recycle = max_recycle or cfg.max_recycle
        self.tol = tol
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None
        # (kind, bucket, plan) -> step; kinds "fold" (run) and "recycle"
        # (serve), both counted by compile_misses: at most twice the table
        self._steps: Dict[tuple, object] = {}
        # (bucket, plan) -> the sample-cycle both kinds of a bucket replay
        self._cycles: Dict[tuple, object] = {}
        self.compile_misses = 0                 # step-cache misses
        self.obs = obs if obs is not None else MetricRegistry()
        self.tracer = tracer
        # lifetime counters, mutated through bump / bump_bucket only, which
        # keep the registry's serve/* counters in step
        self.stats = {"requests": 0, "steps": 0, "recycles_run": 0,
                      "recycles_budget": 0, "per_bucket": {}}
        # deltas of the most recent run() / serve(): lifetime ratios drift
        # as calls accumulate, one call's efficiency is judged on these
        self.last_stats: dict = {}
        self.last_report: dict = {}             # serve()'s report

    # -- stats ---------------------------------------------------------------

    _SCALAR_STATS = ("requests", "steps", "recycles_run", "recycles_budget")

    def bump(self, key: str, n: int = 1) -> None:
        """Add ``n`` to the lifetime counter ``key`` and its registry twin
        ``serve/{key}``."""
        self.stats[key] += n
        self.obs.counter(f"serve/{key}").inc(n)

    def bump_bucket(self, bucket: fs.Bucket, *, requests: int = 0,
                    steps: int = 0, seconds: float = 0.0) -> None:
        pb = self.stats["per_bucket"].setdefault(
            bucket, {"requests": 0, "steps": 0, "seconds": 0.0})
        pb["requests"] += requests
        pb["steps"] += steps
        pb["seconds"] += seconds
        tag = bucket.describe()
        if requests:
            self.obs.counter("serve/bucket_requests", bucket=tag).inc(requests)
        if steps:
            self.obs.counter("serve/bucket_steps", bucket=tag).inc(steps)
        if seconds:
            self.obs.histogram("serve/bucket_step_s", bucket=tag).observe(
                seconds)

    def _call_begin(self) -> dict:
        return {k: self.stats[k] for k in self._SCALAR_STATS}

    def _call_end(self, kind: str, snap: dict) -> dict:
        """``last_stats``: this call's deltas, its kind ("run" / "serve")
        and its recycle fraction, recorded as one ``serve/call`` event."""
        self.last_stats = {k: self.stats[k] - snap[k]
                           for k in self._SCALAR_STATS}
        self.last_stats["call"] = kind
        budget = self.last_stats["recycles_budget"]
        self.last_stats["recycle_fraction"] = (
            self.last_stats["recycles_run"] / budget if budget else 0.0)
        self.obs.record("serve/call", dict(self.last_stats))
        return self.last_stats

    # -- plans and the step cache --------------------------------------------

    def plan_for(self, bucket: fs.Bucket) -> ParallelPlan:
        """The inference plan a bucket runs under."""
        return (self.long_plan if bucket.n_res >= self.long_threshold
                else self.plan)

    def bucket_model_cfg(self, bucket: fs.Bucket):
        """The bucket-shaped model config of a bucket under its plan."""
        return self.plan_for(bucket).apply_to(fs.bucket_cfg(self.cfg, bucket))

    def _built_for(self, plan: ParallelPlan, bcfg) -> BuiltPlan:
        if plan not in self._built:
            self._built[plan] = plan.build(self.ranks, cfg=bcfg,
                                           device=self.device)
        return self._built[plan]

    def _step_cell(self, kind: str, bucket: fs.Bucket, make):
        plan = self.plan_for(bucket)
        key = (kind, bucket, plan)
        if key not in self._steps:
            self.compile_misses += 1
            bcfg = self.bucket_model_cfg(bucket)
            # every cell: the plan's build is cached, so it validates only
            # the first bucket it is built for
            plan.validate(bcfg)
            built = self._built_for(plan, bcfg)
            if (bucket, plan) not in self._cycles:
                self._cycles[bucket, plan] = fs.make_cycle(
                    bcfg, built, dtype=self.dtype, graphs=self.graphs,
                    pool=self._pool)
            self._steps[key] = make(bcfg, built, self._cycles[bucket, plan])
        return self._steps[key]

    def step_for(self, bucket: fs.Bucket):
        """The whole-fold step of this bucket, built once and cached (with
        graphs, the first call of either kind captures the bucket's
        sample-cycle).  Under a plan of several ranks every rank calls it
        together (the first call builds the plan's process groups)."""
        return self._step_cell(
            "fold", bucket,
            lambda bcfg, built, cycle: fs.make_fold_step(
                bcfg, built, max_recycle=self.max_recycle, tol=self.tol,
                dtype=self.dtype, cycle=cycle))

    def recycle_step_for(self, bucket: fs.Bucket):
        """The one-cycle step of this bucket that ``serve`` drives, cached
        as :meth:`step_for` in a cell of its own."""
        return self._step_cell(
            "recycle", bucket,
            lambda bcfg, built, cycle: fs.make_recycle_step(
                bcfg, built, tol=self.tol, dtype=self.dtype, cycle=cycle))

    def slots_for(self, bucket: fs.Bucket) -> int:
        """The micro-batch of a bucket's steps (a scheduler lane's slots):
        ``micro_batch`` rounded up to a multiple of its plan's data
        extent."""
        plan = self.plan_for(bucket)
        data = plan.pod * plan.data
        return (self.micro_batch + data - 1) // data * data

    def agree_wall(self, wall: float) -> float:
        """The largest of the walls the engine's ranks measured for one step
        (``wall`` itself on one device): the step cost every rank advances
        its virtual clock by.  It is agreed over all the engine's ranks,
        whatever the stepped bucket's plan: a bucket under a one-device plan
        runs on every rank alone, and its walls differ from rank to rank
        all the same."""
        if not self.multi_rank:
            return wall
        if self._world is None:
            # one axis over every rank the plans span (a plan of several
            # ranks spans them all: ParallelPlan.build)
            n = max(self.plan.n_devices, self.long_plan.n_devices)
            self._world = mesh_utils.make_mesh((n,), ("engine",),
                                               ranks=self.ranks)
        t = torch.tensor([wall], dtype=torch.float64, device=self.device)
        return float(coll.pmax(t, mesh_utils.Axis(self._world, "engine"))
                     .item())

    def load_weights(self, weights) -> None:
        """Serve ``weights`` from now on, a model or its parameters by key
        path (an EMA): copied into ``params`` in place, cast to its dtype,
        since the captured graphs read that storage."""
        if isinstance(weights, torch.nn.Module):
            weights = dict(weights.named_parameters())
        dst = dict(self.params.named_parameters())
        if sorted(weights) != sorted(dst):
            raise ValueError("weights do not match the engine's parameters")
        with torch.no_grad():
            for k, p in dst.items():
                p.copy_(weights[k])

    def run(self, requests: List[FoldRequest]) -> Dict[int, FoldResult]:
        """Serve the queue to completion; returns {rid: FoldResult}.

        FIFO with same-bucket skip-ahead: the head request picks the bucket,
        then up to micro_batch - 1 later requests of the same bucket ride
        along in its step.
        """
        queue = [(fs.bucket_for(self.buckets, r.features), r)
                 for r in requests]
        done: Dict[int, FoldResult] = {}
        snap = self._call_begin()
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
            self._call_end("run", snap)
        return done

    def _run_group(self, bucket: fs.Bucket, group: List[FoldRequest]):
        padded = [fs.pad_to_bucket(r.features, bucket) for r in group]
        slots = self.slots_for(bucket)
        batch = fs.stack_padded(padded, slots)
        active = np.arange(slots) < len(group)
        step = self.step_for(bucket)
        t0 = time.perf_counter()
        with trace_span("fold_step", tracer=self.tracer,
                        bucket=bucket.describe(), n=len(group)):
            out = step(self.params, batch, active)
            out = {k: v.float().cpu().numpy() if v.is_floating_point()
                   else v.cpu().numpy() for k, v in out.items()}
        dt = time.perf_counter() - t0

        self.bump("requests", len(group))
        self.bump("steps")
        self.bump("recycles_run", int(out["n_recycles"][:len(group)].sum()))
        self.bump("recycles_budget", self.max_recycle * len(group))
        self.bump_bucket(bucket, requests=len(group), steps=1, seconds=dt)

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

    def serve(self, requests: List[FoldRequest], *,
              policy: str = "continuous", clock=None, step_cost=None,
              cache=None, featurize_workers: int = 0,
              starvation_steps: int = 16) -> Dict[int, FoldResult]:
        """Serve requests arriving over virtual time; {rid: FoldResult}.

        Each request carries ``arrival_s`` / ``deadline_s`` / ``priority``
        and is admitted into its bucket's next recycle step by a
        ``ContinuousScheduler`` (``policy="fifo"``: ``run``'s drain order on
        the same steps, the baseline).  ``cache``: a ``ResultCache`` (None:
        no cache).  ``step_cost``: per-bucket virtual
        seconds a step costs, a {Bucket: s} dict or ``callable(bucket)``
        (None: each step's measured wall, agreed across a plan's ranks).
        ``clock``: a ``VirtualClock`` (None: a fresh one at 0).  The
        report lands in ``last_report``, its scalars in the
        ``serve/report/*`` gauges and a ``serve/report`` event.  Under a
        plan of several ranks, ``featurize_workers`` must be 0.
        """
        # deferred: the scheduler imports FoldResult from this module
        from repro_torch.serve.scheduler import ContinuousScheduler
        if featurize_workers > 0 and self.multi_rank:
            raise ValueError(
                "featurize_workers > 0 under a plan of several ranks: the "
                "featurize threads' timing differs from rank to rank, so "
                "the ranks would admit requests at different steps and "
                "their collectives would diverge; pass featurize_workers=0")
        sched = ContinuousScheduler(
            self, policy=policy, clock=clock, step_cost=step_cost,
            cache=cache, featurize_workers=featurize_workers,
            starvation_steps=starvation_steps)
        snap = self._call_begin()
        try:
            results = sched.serve(requests)
        finally:
            sched.featurizer.close()
            self._call_end("serve", snap)
        self.last_report = sched.report
        for k in ("p50_ms", "p99_ms", "goodput_rps", "deadline_hit_rate"):
            if isinstance(self.last_report.get(k), (int, float)):
                self.obs.gauge(f"serve/report/{k}").set(self.last_report[k])
        self.obs.record("serve/report", {
            k: v for k, v in self.last_report.items()
            if isinstance(v, (int, float, str, dict))
            and k not in ("step_wall_s", "trace")})
        return results
