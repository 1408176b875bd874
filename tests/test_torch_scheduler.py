"""The port's continuous-batching pieces against the JAX package's, with no
model: ``feature_digest``, ``ResultCache``, ``FeaturizePipeline``, the
``ContinuousScheduler``'s schedule and report, and the ``FoldEngine``'s
``long_plan`` routing.

The schedule is driven through a scripted stand-in for the recycle step
(numpy for the reference, its torch twin for the port): slot j of a step
runs one more cycle when active and converges once it has run the cycle
count its request carries in ``target_feat``, so no model is compiled.
With injected step costs every schedule is deterministic, and the two
schedulers must take the same one: equal traces, reports and per-request
stage ledgers, equal ``serve/*`` counters (each stand-in counts through its
package's ``FoldEngine.bump`` / ``bump_bucket``) and equal sequences of
``admit`` / ``recycle_step`` / ``harvest`` spans.  Host walls (featurize seconds, measured step walls) are
not deterministic and are compared by count only.
"""
import dataclasses
import time
import types

import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.data.featurize import FeaturizePipeline as JaxFeaturizePipeline
from repro.data.featurize import feature_digest as jax_feature_digest
from repro.parallel.plan import ParallelPlan as JaxParallelPlan
from repro.serve import fold_steps as jfs
from repro.serve.fold_engine import FoldEngine as JaxFoldEngine
from repro.serve.fold_engine import FoldRequest as JaxFoldRequest
from repro.serve.result_cache import ResultCache as JaxResultCache
from repro.serve.scheduler import ContinuousScheduler as JaxScheduler
from repro.serve.scheduler import VirtualClock as JaxClock

from repro_torch import obs as port_obs
from repro_torch.data.featurize import FeaturizePipeline, feature_digest
from repro_torch.parallel.plan import ParallelPlan
from repro_torch.serve import fold_steps as fs
from repro_torch.serve import scheduler as sched_lib
from repro_torch.serve.fold_engine import FoldEngine, FoldRequest
from repro_torch.serve.result_cache import ResultCache
from repro_torch.serve.scheduler import ContinuousScheduler, VirtualClock

import torch_threads  # noqa: F401  (one intra-op thread)

SHAPES = {"small": (6, 3, 4), "big": (12, 6, 8)}
BUCKETS = [(8, 4, 6), (16, 8, 12)]
COSTS = (1.0, 3.0)                  # injected seconds a step, by bucket
MAX_RECYCLE = 3


def _features(rid, kind, cycles):
    """Request features of ``kind``'s shape; ``target_feat`` carries the
    cycle count after which the stand-in step converges (a fold's values
    are immaterial to the schedule)."""
    r, s, se = SHAPES[kind]
    rng = np.random.default_rng([11, rid])
    return {"msa_feat": rng.standard_normal((s, r, 3)).astype(np.float32),
            "extra_msa_feat": rng.standard_normal((se, r, 2)).astype(
                np.float32),
            "target_feat": np.full((r, 1), cycles, np.float32),
            "residue_index": np.arange(r, dtype=np.int32)}


def _ref_step(batch, carry):
    """The reference side's stand-in recycle step (numpy)."""
    carry = {k: np.array(v) for k, v in carry.items()}
    run = carry["active"] & ~carry["conv"]
    carry["n_rec"] = carry["n_rec"] + run.astype(np.int32)
    want = batch["target_feat"][:, 0, 0].astype(np.int32)
    carry["conv"] = carry["conv"] | (run & (carry["n_rec"] >= want))
    n, r = batch["target_feat"].shape[:2]
    base = (carry["n_rec"][:, None] + batch["residue_index"]).astype(
        np.float32)
    out = {"coords": np.repeat(base[:, :, None], 3, axis=2),
           "plddt": base * 2.0,
           "contact_probs": base[:, :, None] * np.ones((1, 1, r), np.float32)}
    return carry, out


def _port_step(batch, carry):
    """Its torch twin: the same arithmetic on the port's device carry."""
    run = carry["active"] & ~carry["conv"]
    n_rec = carry["n_rec"] + run.to(torch.int32)
    want = batch["target_feat"][:, 0, 0].to(torch.int32)
    carry = dict(carry, n_rec=n_rec,
                 conv=carry["conv"] | (run & (n_rec >= want)))
    r = batch["target_feat"].shape[1]
    base = (n_rec[:, None] + batch["residue_index"]).float()
    out = {"coords": base[:, :, None].repeat(1, 1, 3),
           "plddt": base * 2.0,
           "contact_probs": base[:, :, None] * torch.ones((1, 1, r))}
    return carry, out


class _StandInEngine:
    """What a scheduler reads of its FoldEngine, over the stand-in step;
    its stats and ``serve/*`` counters change through ``engine_cls``'s own
    ``bump`` / ``bump_bucket``, its spans go to a tracer of ``obs_lib``."""

    def __init__(self, bucket_cls, step, engine_cls=FoldEngine,
                 obs_lib=port_obs, slots=2):
        self.buckets = sorted(bucket_cls(*b) for b in BUCKETS)
        self.costs = dict(zip(self.buckets, COSTS))
        self._step, self._slots = step, slots
        self._engine_cls = engine_cls
        self.max_recycle = MAX_RECYCLE
        self.params = None
        self.obs = obs_lib.MetricRegistry()
        self.tracer = obs_lib.SpanTracer()
        self.device, self.dtype = torch.device("cpu"), torch.float32
        self.stats = {"requests": 0, "steps": 0, "recycles_run": 0,
                      "recycles_budget": 0, "per_bucket": {}}

    def slots_for(self, bucket):
        return self._slots

    def bucket_model_cfg(self, bucket):
        return types.SimpleNamespace(
            n_res=bucket.n_res, c_m=2, c_z=2,
            structure=types.SimpleNamespace(c_s=2))

    def recycle_step_for(self, bucket):
        return lambda params, batch, carry: self._step(batch, carry)

    def bump(self, key, n=1):
        self._engine_cls.bump(self, key, n)

    def bump_bucket(self, bucket, **kw):
        self._engine_cls.bump_bucket(self, bucket, **kw)

    def agree_wall(self, wall):
        return wall


# scenarios: (kind, cycles, arrival, deadline, priority) per request, the
# cache capacity (None: none), requests repeating an earlier one's
# features (rid -> rid), and the starvation bound
SCENARIOS = {
    "staggered": (
        [("small", 2, 0.0, 6.0, 0), ("big", 3, 0.2, None, 0),
         ("small", 1, 0.4, 3.0, 1), ("big", 2, 0.9, 20.0, 0),
         ("small", 3, 1.5, None, 0), ("small", 2, 1.6, 4.0, 1),
         ("big", 1, 2.0, 9.0, 0), ("small", 2, 30.0, None, 0),
         ("big", 3, 31.0, 40.0, 1)],
        8, {7: 0, 8: 1}, 2),
    "starvation": (
        [("big", 3, 0.0, None, 0)] + [("small", 3, 0.0, 2.0, 0)] * 6
        + [("small", 2, 2.5, 1.0, 1)],
        None, {}, 2),
    "evictions": (
        [("small", 1, 0.0, None, 0), ("small", 1, 5.0, None, 0),
         ("big", 2, 6.0, 7.0, 0), ("small", 1, 20.0, None, 0),
         ("small", 1, 30.0, 31.0, 2), ("big", 2, 40.0, None, 0)],
        1, {1: 0, 3: 0, 4: 3, 5: 2}, 2),
}


def _requests(req_cls, name):
    specs, _, dups, _ = SCENARIOS[name]
    feats = [_features(i, kind, cyc)
             for i, (kind, cyc, _, _, _) in enumerate(specs)]
    for rid, src in dups.items():
        feats[rid] = feats[src]
    return [req_cls(rid=i, features=feats[i], arrival_s=arr,
                    deadline_s=dl, priority=pr)
            for i, (_, _, arr, dl, pr) in enumerate(specs)]


def _serve(sched_cls, clock_cls, cache_cls, engine, reqs, name, policy):
    _, cap, _, starve = SCENARIOS[name]
    sched = sched_cls(engine, policy=policy, clock=clock_cls(),
                      step_cost=engine.costs,
                      cache=cache_cls(cap) if cap else None,
                      starvation_steps=starve)
    out = sched.serve(reqs)
    return out, sched.report


def _key(b):
    return (b.n_res, b.n_seq, b.n_extra_seq)


def _serve_obs(engine):
    """The ``serve/*`` counters, the step-wall histograms' counts (their
    sums are host walls) and the (span name, bucket) sequence."""
    snap = engine.obs.snapshot()
    counters = {k: v for k, v in snap.items() if k.startswith("serve/")
                and not k.startswith("serve/bucket_step_s")}
    hist = {k: v["count"] for k, v in snap.items()
            if k.startswith("serve/bucket_step_s")}
    spans = [(e["name"], e["args"]["bucket"]) for e in engine.tracer.spans()]
    return counters, hist, spans


RESULT_FIELDS = ("finish_s", "latency_s", "queue_s", "service_s",
                 "cache_hit", "n_recycles", "converged")


@pytest.mark.parametrize("policy", ["continuous", "fifo"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_schedule_matches_reference(name, policy):
    jeng = _StandInEngine(jfs.Bucket, _ref_step, JaxFoldEngine, jax_obs)
    peng = _StandInEngine(fs.Bucket, _port_step)
    want, wrep = _serve(JaxScheduler, JaxClock, JaxResultCache, jeng,
                        _requests(JaxFoldRequest, name), name, policy)
    got, grep_ = _serve(ContinuousScheduler, VirtualClock, ResultCache, peng,
                        _requests(FoldRequest, name), name, policy)
    # telemetry: the same counters and the same spans, in the same order
    (pc, ph, ps), (jc, jh, js) = _serve_obs(peng), _serve_obs(jeng)
    assert pc == jc and ph == jh and ps == js
    assert pc["serve/steps"] == {"value": wrep["steps"]}
    assert sum(n == "recycle_step" for n, _ in ps) == wrep["steps"]
    assert sorted(got) == sorted(want) == list(range(len(want)))
    for rid in want:
        for f in RESULT_FIELDS:
            assert getattr(got[rid], f) == getattr(want[rid], f), (rid, f)
        assert _key(got[rid].bucket) == _key(want[rid].bucket)
        for k in ("coords", "plddt", "contact_probs"):
            np.testing.assert_array_equal(getattr(got[rid], k),
                                          getattr(want[rid], k))
    # the port's report adds the host <-> device bytes
    assert set(grep_) == set(wrep) | {"transfer_bytes"}
    walls = ("step_wall_s", "trace", "stage_ms", "featurize_stats")
    for k in set(wrep) - set(walls):
        assert grep_[k] == wrep[k], k
    assert [dict(t, bucket=_key(t["bucket"])) for t in grep_["trace"]] == \
        [dict(t, bucket=_key(t["bucket"])) for t in wrep["trace"]]
    for k in ("queue", "service"):
        assert grep_["stage_ms"][k] == wrep["stage_ms"][k]
    for k in ("featurized", "max_inflight"):
        assert grep_["featurize_stats"][k] == wrep["featurize_stats"][k]
    assert {_key(b): len(w) for b, w in grep_["step_wall_s"].items()} == \
        {_key(b): len(w) for b, w in wrep["step_wall_s"].items()}
    # what each scenario is for
    if name == "starvation" and policy == "continuous":
        assert wrep["forced_admissions"] >= 1
    if name == "staggered":
        assert wrep["cache_hits"] == 2
    if name == "evictions":
        assert wrep["cache_hits"] == 2 and wrep["completed"] == 6


def test_measured_step_wall_holds_admission_and_harvest_copies(monkeypatch):
    """With measured costs a step's wall, and the clock's advance, runs
    from its admission's host-to-device copies to its harvested outputs'
    device-to-host copies."""
    pause = 0.02

    def slowed(fn):
        def call(*a, **kw):
            time.sleep(pause)
            return fn(*a, **kw)
        return call

    for name in ("admit", "pull_output"):
        monkeypatch.setattr(sched_lib._Lane, name,
                            slowed(getattr(sched_lib._Lane, name)))
    req = FoldRequest(rid=0, features=_features(0, "small", 1))
    sched = ContinuousScheduler(_StandInEngine(fs.Bucket, _port_step),
                                step_cost=None)
    done = sched.serve([req])
    # one step: one admission, three outputs of the harvested slot
    [wall] = sched.report["step_wall_s"][fs.Bucket(*BUCKETS[0])]
    assert wall >= 4 * pause
    assert done[0].finish_s == sched.trace[0]["t"] == wall


def test_feature_digest_matches_reference():
    base = _features(0, "big", 2)
    variants = {
        "same": base,
        "reordered": dict(reversed(list(base.items()))),
        "value": dict(base, residue_index=base["residue_index"] + 1),
        "dtype": dict(base, residue_index=base["residue_index"].astype(
            np.int64)),
        "shape": dict(base, target_feat=base["target_feat"].reshape(-1)),
        "key": {("x" + k if k == "msa_feat" else k): v
                for k, v in base.items()},
    }
    got = {k: feature_digest(v) for k, v in variants.items()}
    want = {k: jax_feature_digest(v) for k, v in variants.items()}
    assert got == want
    assert got["reordered"] == got["same"]
    assert len({got[k] for k in ("same", "value", "dtype", "shape",
                                 "key")}) == 5


def test_result_cache_matches_reference():
    script = [("get", "a"), ("put", "a"), ("put", "b"), ("get", "a"),
              ("put", "c"), ("get", "b"), ("get", "c"), ("put", "a"),
              ("put", "d"), ("get", "a"), ("get", "d"), ("get", "e")]
    caches = [ResultCache(2), JaxResultCache(2)]
    logs = [[], []]
    for cache, log in zip(caches, logs):
        for i, (op, key) in enumerate(script):
            if op == "put":
                cache.put(key, i)
            else:
                log.append(cache.get(key))
            log.append((cache.hits, cache.misses, cache.evictions,
                        len(cache), key in cache, cache.hit_rate))
    assert logs[0] == logs[1]
    assert caches[0].stats == caches[1].stats
    assert caches[0].evictions >= 2
    for cls in (ResultCache, JaxResultCache):
        with pytest.raises(ValueError):
            cls(0)


def _padded_items(pipe, reqs):
    try:
        for r in reqs:
            pipe.submit(r)
        items = []
        while len(items) < len(reqs):
            items += pipe.poll(block=True, timeout=30)
    finally:
        pipe.close()
    return {it.request.rid: it for it in items}


@pytest.mark.parametrize("workers", [0, 2])
def test_featurize_pipeline_matches_reference(workers):
    kinds = ["small", "big", "small", "big", "small", "small"]
    feats = [_features(i, k, 2) for i, k in enumerate(kinds)]
    want_pipe = JaxFeaturizePipeline([jfs.Bucket(*b) for b in BUCKETS],
                                     workers=0)
    got_pipe = FeaturizePipeline([fs.Bucket(*b) for b in BUCKETS],
                                 workers=workers)
    assert [got_pipe.depth_for(fs.Bucket(*b)) for b in BUCKETS] == \
        [want_pipe.depth_for(jfs.Bucket(*b)) for b in BUCKETS]
    want = _padded_items(want_pipe, [JaxFoldRequest(rid=i, features=f)
                                     for i, f in enumerate(feats)])
    got = _padded_items(got_pipe, [FoldRequest(rid=i, features=f)
                                   for i, f in enumerate(feats)])
    assert sorted(got) == sorted(want)
    for rid, it in want.items():
        assert got[rid].digest == it.digest
        assert _key(got[rid].bucket) == _key(it.bucket)
        assert sorted(got[rid].padded) == sorted(it.padded)
        for k, v in it.padded.items():
            np.testing.assert_array_equal(got[rid].padded[k], v)
            assert got[rid].padded[k].dtype == v.dtype
    assert got_pipe.stats["featurized"] == len(feats)


def test_featurize_worker_exception_reaches_poll():
    pipe = FeaturizePipeline([fs.Bucket(*b) for b in BUCKETS], workers=2)
    # bucketed (the in-flight bound reads its shapes), but not paddable
    broken = {k: v for k, v in _features(1, "big", 1).items()
              if k != "residue_index"}
    try:
        pipe.submit(FoldRequest(rid=0, features=_features(0, "small", 1)))
        pipe.submit(FoldRequest(rid=1, features=broken))
        with pytest.raises(KeyError, match="residue_index"):
            for _ in range(50):
                pipe.poll(block=True, timeout=30)
    finally:
        pipe.close()


def test_plan_routing_matches_reference():
    """The reference's ``test_plan_routing_and_inference_normalization``
    on both engines (no ranks are built): ``for_inference`` folds branch
    into data and drops remat, buckets at or above ``long_threshold`` route
    to ``long_plan``, the default threshold is the largest bucket's
    ``n_res``, and a lane's slots round the micro-batch up to the routed
    plan's data extent."""
    from repro_torch.core.config import af2_tiny
    from repro_torch.core.model import AlphaFold2
    from repro.core.config import af2_tiny as jax_af2_tiny
    model = AlphaFold2(af2_tiny(), device="cpu")
    kw = {"branch": 2, "variant": "parallel", "remat": "block"}
    for threshold in (16, None):
        for micro in (2, 3):
            got = FoldEngine(af2_tiny(), model,
                             buckets=[fs.Bucket(*b) for b in BUCKETS],
                             long_plan=ParallelPlan(**kw),
                             long_threshold=threshold, micro_batch=micro,
                             device="cpu")
            want = JaxFoldEngine(jax_af2_tiny(), None,
                                 buckets=[jfs.Bucket(*b) for b in BUCKETS],
                                 long_plan=JaxParallelPlan(**kw),
                                 long_threshold=threshold,
                                 micro_batch=micro)
            assert got.long_plan.to_dict() == dataclasses.asdict(
                want.long_plan)
            assert (got.long_plan.branch, got.long_plan.data,
                    got.long_plan.remat) == (1, 2, "none")
            assert got.long_threshold == want.long_threshold == 16
            small, big = (fs.Bucket(*b) for b in BUCKETS)
            assert got.plan_for(small) is got.plan
            assert got.plan_for(big) is got.long_plan
            for b, jb in zip((small, big), (jfs.Bucket(*b) for b in BUCKETS)):
                assert (got.plan_for(b) is got.long_plan) == \
                    (want.plan_for(jb) is want.long_plan)
                assert got.slots_for(b) == want.slots_for(jb)
                assert got.bucket_model_cfg(b).n_res == \
                    want.bucket_model_cfg(jb).n_res
            assert got.slots_for(big) == (4 if micro == 3 else 2)
