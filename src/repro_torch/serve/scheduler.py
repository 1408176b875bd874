"""Continuous-batching admission scheduler of fold serving (counterpart of
``repro/serve/scheduler.py``).

``FoldEngine.run`` drains a queue: a micro-batch recycles to completion
before the next starts, so a request arriving just after a batch began
waits for its whole fold though its bucket has free slots.  Here requests
are admitted at recycle-step granularity:

* every bucket owns a **lane**: a fixed micro-batch of slots, their
  features and their recycling carry, all on the engine's device
  (``fold_steps.init_recycle_carry``);
* one recycle step (``FoldEngine.recycle_step_for``) advances every active
  slot by one cycle; inactive slots never run (``core.model.fold_cycle``),
  so writing a request's padded features into a free slot between steps
  cannot perturb the requests in flight;
* a slot is harvested the moment it converges or has run ``max_recycle``
  cycles, which frees it for the next waiting request;
* across lanes, steps go by urgency, ``(-priority, deadline, arrival)``
  over each lane's waiting and in-flight requests, with a **starvation
  bound**: a lane passed over ``starvation_steps`` times with work waiting
  runs next whatever its urgency;
* ``policy="fifo"`` is ``run``'s drain on the same steps (admission only
  into an idle engine, a group served to completion, same-bucket
  skip-ahead): the baseline that isolates the policy.

Time is virtual (``VirtualClock``): arrivals carry ``arrival_s`` stamps and
each step advances the clock by its measured wall or an injected
per-bucket cost, which makes every latency deterministic with inline
featurization.  With featurize threads a request is admitted at the first
step after its thread finished; an idle scheduler waits for the threads
before it jumps to the next arrival (the reference jumps first, so a
request still in a thread then counts as ready only at that arrival).
A request's
fold does not depend on the schedule, so both policies return the same
folds; only when each finishes differs.

What crosses between host and device each step: the ``conv`` and ``n_rec``
flags (read after the step, which waits for the device) and the
coordinates, pLDDT and contact probabilities of the slots harvested; a
request's padded features go to its slot once, at admission
(``report["transfer_bytes"]``).  The reference round-trips the whole fp32
carry and every output through the host each step.  A step's measured
wall, the virtual cost it advances the clock by, runs from before its
admissions' host-to-device copies to after its harvested slots'
device-to-host copies, so it holds every transfer a user waits for, as the
reference's step holds its batch transfer and output copies.

Spans on the engine's tracer, as the reference's: ``admit`` (bucket),
``recycle_step`` (bucket, active slots; it closes after the step's host
copies) and ``harvest`` (bucket).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.data.featurize import FeaturizePipeline
from repro_torch.obs import trace_span
from repro_torch.serve import fold_steps as fs
from repro_torch.serve.fold_engine import FoldResult


class VirtualClock:
    """Monotone simulated clock: arrivals and step costs advance it, wall
    time never does."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self._t += float(dt)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _Lane:
    """One bucket's slots: their features and recycling carry on the
    engine's device, host copies of the carry's flags, the requests in
    them and the queue waiting for them."""

    def __init__(self, engine, bucket: fs.Bucket):
        self.bucket = bucket
        self.device = engine.device
        self.slots = engine.slots_for(bucket)
        self.step = engine.recycle_step_for(bucket)
        self.carry = fs.init_recycle_carry(
            engine.bucket_model_cfg(bucket), self.slots, engine.device,
            engine.dtype)
        # ``active`` is written here and on the device together; ``conv``
        # and ``n_rec`` are read back after every step
        self.flags = {"active": np.zeros(self.slots, bool),
                      "conv": np.zeros(self.slots, bool),
                      "n_rec": np.zeros(self.slots, np.int32)}
        self.batch: Optional[dict] = None   # (slots, ...) tensors
        self.meta: List[Optional[object]] = [None] * self.slots  # Featurized
        self.waiting: List[object] = []     # Featurized, sorted at admit
        self.skipped = 0                    # steps run elsewhere while we wait
        self.bytes = {"h2d": 0, "d2h": 0}

    @property
    def n_active(self) -> int:
        return int(self.flags["active"].sum())

    @property
    def free_slots(self) -> List[int]:
        return [j for j in range(self.slots) if not self.flags["active"][j]]

    def has_work(self) -> bool:
        return bool(self.waiting) or self.n_active > 0

    def admit(self, item, now: float) -> int:
        """Write one featurized request into a free slot (between steps)."""
        j = self.free_slots[0]
        feats = {k: torch.as_tensor(v) for k, v in item.padded.items()}
        if self.batch is None:
            # filler: the first admission in every slot, so free slots hold
            # well-formed (masked) features; they never run
            self.batch = {k: v.expand(self.slots, *v.shape).contiguous()
                          .to(self.device) for k, v in feats.items()}
            self.bytes["h2d"] += self.slots * _nbytes(feats.values())
        else:
            for k, v in feats.items():
                self.batch[k][j].copy_(v)
            self.bytes["h2d"] += _nbytes(feats.values())
        self.clear(j)
        self.carry["active"][j] = True
        self.flags["active"][j] = True
        self.meta[j] = item
        item.admit_s = now
        return j

    def clear(self, j: int) -> None:
        fs.clear_carry_slot(self.carry, j)
        for v in self.flags.values():
            v[j] = 0

    def pull_flags(self) -> None:
        """Read ``conv`` and ``n_rec`` back to the host: one copy, which
        waits for the step's work on the device."""
        host = torch.stack([self.carry["conv"].to(torch.int32),
                            self.carry["n_rec"]]).cpu()
        self.bytes["d2h"] += _nbytes([host])
        host = host.numpy()
        self.flags["conv"] = host[0].astype(bool)
        self.flags["n_rec"] = host[1].copy()

    def pull_output(self, out: dict, key: str, j: int, r: int) -> np.ndarray:
        """Slot ``j``'s output ``key`` trimmed to its ``r`` residues, on
        the host as ``run`` returns it: a copy (``coords`` is the carry's
        ``x``, which the slot's harvest zeroes)."""
        t = out[key][j, :r, :r] if key == "contact_probs" else out[key][j, :r]
        t = t.to(device="cpu", dtype=torch.float32, copy=True)
        self.bytes["d2h"] += _nbytes([t])
        return t.numpy()


def _order_key(req):
    """Urgency: priority desc, then deadline, then arrival, then rid."""
    dl = req.deadline_s if req.deadline_s is not None else float("inf")
    return (-req.priority, dl, req.arrival_s, req.rid)


def _fifo_key(req):
    return (req.arrival_s, req.rid)


class ContinuousScheduler:
    """Admission scheduler over a FoldEngine's recycle steps.

    ``step_cost``: None advances the virtual clock by each step's measured
    wall, admission and harvest copies included (under a plan of several
    ranks the largest rank's, ``FoldEngine.agree_wall``); a
    ``{Bucket: seconds}`` dict or ``callable(bucket) -> s`` by the
    injected cost (deterministic).
    """

    def __init__(self, engine, *, policy: str = "continuous",
                 clock: Optional[VirtualClock] = None, step_cost=None,
                 cache=None, featurize_workers: int = 0,
                 starvation_steps: int = 16):
        if policy not in ("continuous", "fifo"):
            raise ValueError(f"unknown policy {policy!r}; use 'continuous' "
                             "or 'fifo'")
        if starvation_steps < 1:
            raise ValueError("starvation_steps must be >= 1")
        self.engine = engine
        self.policy = policy
        self.clock = clock or VirtualClock()
        self.step_cost = step_cost
        self.cache = cache
        self.featurizer = FeaturizePipeline(engine.buckets,
                                            workers=featurize_workers)
        self.starvation_steps = starvation_steps
        self.lanes: Dict[fs.Bucket, _Lane] = {}
        self.results: Dict[int, object] = {}
        self.trace: List[dict] = []
        self.steps = 0
        self.virtual_step_s = 0.0
        self.cache_hits = 0
        self.forced_admissions = 0
        self.step_wall_s: Dict[fs.Bucket, List[float]] = {}
        self._deadlines: Dict[int, Optional[float]] = {}
        self.report: dict = {}

    # -- stages --------------------------------------------------------------

    def _lane(self, bucket: fs.Bucket) -> _Lane:
        if bucket not in self.lanes:
            self.lanes[bucket] = _Lane(self.engine, bucket)
        return self.lanes[bucket]

    def _ingest_arrivals(self, pending: deque, now: float) -> None:
        while pending and pending[0].arrival_s <= now:
            self.featurizer.submit(pending.popleft())

    def _drain_featurized(self, now: float, block: bool = False) -> None:
        for item in self.featurizer.poll(block=block):
            item.ready_s = max(now, item.request.arrival_s)
            if self.cache is not None:
                hit = self.cache.get(item.digest)
                if hit is not None:
                    self.cache_hits += 1
                    req = item.request
                    self.results[req.rid] = dataclasses.replace(
                        hit, rid=req.rid, cache_hit=True,
                        latency_s=item.ready_s - req.arrival_s,
                        featurize_s=item.featurize_s,
                        queue_s=0.0, service_s=0.0, finish_s=item.ready_s)
                    continue
            self._lane(item.bucket).waiting.append(item)

    # -- lane selection ------------------------------------------------------

    def _pick_lane(self) -> Optional[_Lane]:
        live = [ln for ln in self.lanes.values() if ln.has_work()]
        if not live:
            return None
        if self.policy == "fifo":
            # at most one lane is active under fifo (admission only into
            # an idle engine); otherwise serve the globally oldest
            active = [ln for ln in live if ln.n_active]
            if active:
                return active[0]
            return min(live, key=lambda ln: min(
                _fifo_key(it.request) for it in ln.waiting))
        starved = [ln for ln in live if ln.waiting
                   and ln.skipped >= self.starvation_steps]
        if starved:
            lane = min(starved, key=lambda ln: min(
                it.request.arrival_s for it in ln.waiting))
            self.forced_admissions += 1
            return lane

        def urgency(ln):
            reqs = [it.request for it in ln.waiting]
            reqs += [m.request for m in ln.meta if m is not None]
            return min(_order_key(r) for r in reqs)
        return min(live, key=urgency)

    def _admit(self, lane: _Lane, now: float) -> List[int]:
        key = _fifo_key if self.policy == "fifo" else _order_key
        lane.waiting.sort(key=lambda it: key(it.request))
        admitted = []
        with trace_span("admit", tracer=self.engine.tracer,
                        bucket=lane.bucket.describe()):
            while lane.waiting and lane.free_slots:
                item = lane.waiting.pop(0)
                lane.admit(item, now)
                admitted.append(item.request.rid)
        return admitted

    # -- stepping ------------------------------------------------------------

    def _cost(self, bucket: fs.Bucket, wall: float) -> float:
        if self.step_cost is None:
            return wall
        if callable(self.step_cost):
            return float(self.step_cost(bucket))
        return float(self.step_cost[bucket])

    def _run_step(self, lane: _Lane, now: float, forced: bool) -> None:
        """Admit into ``lane`` (continuous, or fifo into an idle lane), run
        its recycle step and harvest it; the measured wall runs from the
        admissions' copies to the harvested outputs' copies.  The
        ``recycle_step`` span closes after the step's host copies (its
        flags and the harvested outputs)."""
        eng = self.engine
        t0 = time.perf_counter()
        if self.policy == "continuous" or lane.n_active == 0:
            admitted = self._admit(lane, now)
        else:
            admitted = []
        with trace_span("recycle_step", tracer=eng.tracer,
                        bucket=lane.bucket.describe(), active=lane.n_active):
            lane.carry, out = lane.step(eng.params, lane.batch, lane.carry)
            lane.pull_flags()
            done = self._pull_harvest(lane, out)
        wall = time.perf_counter() - t0
        if self.step_cost is None:
            wall = eng.agree_wall(wall)
        dt = self._cost(lane.bucket, wall)
        self.clock.advance(dt)
        self.steps += 1
        self.virtual_step_s += dt
        self.step_wall_s.setdefault(lane.bucket, []).append(wall)
        active_rids = [m.request.rid for m in lane.meta if m is not None]
        self.trace.append({"t": self.clock.now(), "bucket": lane.bucket,
                           "active": active_rids, "admitted": admitted,
                           "forced": forced})
        for other in self.lanes.values():
            if other is not lane and other.waiting:
                other.skipped += 1
        lane.skipped = 0
        eng.bump("steps")
        eng.bump_bucket(lane.bucket, steps=1, seconds=wall)
        with trace_span("harvest", tracer=eng.tracer,
                        bucket=lane.bucket.describe()):
            self._harvest(lane, done)

    def _pull_harvest(self, lane: _Lane, out: dict) -> Dict[int, dict]:
        """{slot: host outputs} of the slots that converged or ran
        ``max_recycle`` cycles in the step just run."""
        f = lane.flags
        done = {}
        for j in range(lane.slots):
            if not f["active"][j]:
                continue
            if not (f["conv"][j] or f["n_rec"][j] >= self.engine.max_recycle):
                continue
            r = fs.request_shapes(lane.meta[j].request.features)[0]
            done[j] = {k: lane.pull_output(out, k, j, r)
                       for k in ("coords", "plddt", "contact_probs")}
        return done

    def _harvest(self, lane: _Lane, done: Dict[int, dict]) -> None:
        """Finish the requests of the slots ``_pull_harvest`` found done, at
        the clock's instant after their step, and free their slots."""
        eng = self.engine
        now = self.clock.now()
        f = lane.flags
        for j, host in done.items():
            item = lane.meta[j]
            req = item.request
            item.finish_s = now
            n_rec = int(f["n_rec"][j])
            res = FoldResult(
                rid=req.rid, **host,
                n_recycles=n_rec,
                converged=bool(f["conv"][j]),
                bucket=lane.bucket,
                latency_s=now - req.arrival_s,
                featurize_s=item.featurize_s,
                queue_s=item.admit_s - item.ready_s,
                service_s=now - item.admit_s,
                finish_s=now)
            self.results[req.rid] = res
            if self.cache is not None:
                self.cache.put(item.digest, res)
            eng.bump("requests")
            eng.bump("recycles_run", n_rec)
            eng.bump("recycles_budget", eng.max_recycle)
            eng.bump_bucket(lane.bucket, requests=1)
            lane.clear(j)
            lane.meta[j] = None

    # -- main loop -----------------------------------------------------------

    def serve(self, requests: List[object]) -> Dict[int, object]:
        pending = deque(sorted(requests,
                               key=lambda r: (r.arrival_s, r.rid)))
        self._deadlines = {r.rid: r.deadline_s for r in pending}
        n = len(pending)
        t0v = self.clock.now()
        while True:
            now = self.clock.now()
            self._ingest_arrivals(pending, now)
            self._drain_featurized(now)
            lane = self._pick_lane()
            if lane is None:
                if self.featurizer.pending:
                    # requests in the featurize threads are ready now: the
                    # reference jumps to the next arrival first, which
                    # makes them ready at that arrival
                    self._drain_featurized(now, block=True)
                    continue
                if pending:
                    # idle: jump to the next arrival
                    self.clock.advance(
                        max(0.0, pending[0].arrival_s - now))
                    continue
                break
            forced = (self.policy == "continuous" and bool(lane.waiting)
                      and lane.skipped >= self.starvation_steps)
            self._run_step(lane, now, forced)
        self.report = self._build_report(n, t0v)
        return self.results

    def _build_report(self, n: int, t0v: float) -> dict:
        res = list(self.results.values())
        lat_ms = np.array([r.latency_s for r in res]) * 1e3 \
            if res else np.zeros(1)
        first = min((r.finish_s - r.latency_s for r in res),
                    default=t0v)
        last = max((r.finish_s for r in res), default=self.clock.now())
        elapsed = max(last - first, 1e-9)
        on_time = sum(1 for r in res
                      if r.cache_hit
                      or self._deadlines.get(r.rid) is None
                      or r.finish_s <= self._deadlines[r.rid])
        mean = lambda xs: float(np.mean(xs)) if len(xs) else 0.0  # noqa: E731
        return {
            "policy": self.policy,
            "requests": n,
            "completed": len(res),
            "cache_hits": self.cache_hits,
            "hit_rate": (self.cache.hit_rate if self.cache is not None
                         else 0.0),
            "steps": self.steps,
            "virtual_step_s": self.virtual_step_s,
            "elapsed_s": elapsed,
            "utilization": self.virtual_step_s / elapsed,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "mean_ms": float(np.mean(lat_ms)),
            "goodput_rps": on_time / elapsed,
            "on_time_frac": on_time / max(n, 1),
            "stage_ms": {
                "featurize": mean([r.featurize_s * 1e3 for r in res]),
                "queue": mean([r.queue_s * 1e3 for r in res]),
                "service": mean([r.service_s * 1e3 for r in res]),
            },
            "featurize_stats": dict(self.featurizer.stats),
            "forced_admissions": self.forced_admissions,
            "step_wall_s": self.step_wall_s,
            "trace": self.trace,
            "transfer_bytes": {
                k: sum(ln.bytes[k] for ln in self.lanes.values())
                for k in ("h2d", "d2h")},
        }


def calibrate_step_costs(engine, requests, *, policy: str = "fifo") -> dict:
    """Per-bucket recycle-step costs measured by serving ``requests``:
    ``{Bucket: median wall seconds}``, a cost table to inject as
    ``step_cost`` so that latencies are reproducible (the median damps a
    first step's capture)."""
    engine.serve(list(requests), policy=policy, clock=VirtualClock(),
                 step_cost=None)
    walls = engine.last_report["step_wall_s"]
    return {b: float(np.median(w)) for b, w in walls.items()}
