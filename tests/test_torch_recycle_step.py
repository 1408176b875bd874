"""The port's stepwise recycle step and ``FoldEngine.serve`` against the JAX
package, at af2_tiny with 1 + 1 blocks, fp32, on the CPU.

* Three steps of ``make_recycle_step`` against the reference's on the same
  bridge-loaded weights and features, with a second request admitted into
  slot 1 before step 2: carry and outputs within 1e-4, pLDDT within 1e-3
  (the tolerances of ``tests/test_torch_predict.py``), the flags exactly.
* ``serve`` itself (port only): continuous equals FIFO bit for bit and
  both equal ``run`` within 1e-4; a mid-flight admission leaves the
  request in flight unchanged; ``compile_misses`` counts what the
  reference's engine counts for the same calls.
* Every (kind, bucket, plan) cell validates its plan against its bucket,
  so a second bucket that a DAP plan does not divide raises ``PlanError``
  (the plan's build is stubbed: no ranks).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import af2_tiny
from repro.serve import fold_steps as jfs
from repro.serve.fold_engine import FoldEngine as JaxFoldEngine
from repro.serve.fold_engine import FoldRequest as JaxFoldRequest
from repro.serve.scheduler import VirtualClock as JaxClock

from repro_torch.core import model as taf2
from repro_torch.data.synthetic import fold_features
from repro_torch.parallel import plan as plan_lib
from repro_torch.parallel import ranks
from repro_torch.parallel.plan import ParallelPlan, PlanError
from repro_torch.serve import fold_steps as fs
from repro_torch.serve.fold_engine import FoldEngine, FoldRequest
from repro_torch.serve.result_cache import ResultCache
from repro_torch.serve.scheduler import VirtualClock, calibrate_step_costs

import torch_serve_worker as serve_worker
from torch_util import af2_tree, load_into, port_cfg, randomize_np, to_np

CFG = dataclasses.replace(af2_tiny(), n_evoformer=1, n_extra_msa_blocks=1)
PCFG = port_cfg(CFG)
BUCKET = (8, 4, 6)
BUCKETS = [BUCKET, (16, 8, 12)]
COSTS = (1.0, 3.0)
MAX_RECYCLE = 3
# the JAX oracle runs a few times: XLA's cheapest backend passes
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module")
def models():
    params = randomize_np(af2_tree(CFG), 1, 0.02)
    return params, load_into(taf2.AlphaFold2(PCFG, device="cpu"), params)


def _features(rid, r, s, se):
    c = dataclasses.replace(CFG, n_res=r, n_seq=s, n_extra_seq=se)
    return fold_features(np.random.default_rng([5, rid]), c)


def test_recycle_step_matches_jax_across_an_admission(models):
    params, model = models
    jeng = JaxFoldEngine(CFG, params, buckets=[jfs.Bucket(*BUCKET)],
                         micro_batch=2, max_recycle=MAX_RECYCLE, tol=0.0,
                         dtype=jnp.float32)
    jb = jfs.Bucket(*BUCKET)
    bucket = fs.Bucket(*BUCKET)
    a = fs.pad_to_bucket(_features(0, *BUCKET), bucket)
    b = fs.pad_to_bucket(_features(1, 6, 3, 5), bucket)
    batch = fs.stack_padded([a], 2)          # slot 1: a filler copy of a
    jcarry = jfs.init_recycle_carry(jeng.bucket_model_cfg(jb), 2)
    jcarry["active"][0] = True
    jstep = jeng.recycle_step_for(jb).lower(params, batch, jcarry).compile(
        compiler_options=FAST_COMPILE)
    bcfg = fs.bucket_cfg(PCFG, bucket)
    step = fs.make_recycle_step(bcfg, tol=0.0, dtype=torch.float32)
    tbatch = {k: torch.as_tensor(v.copy()) for k, v in batch.items()}
    carry = fs.init_recycle_carry(bcfg, 2, torch.device("cpu"),
                                  torch.float32)
    assert set(carry) == set(jcarry) == set(fs.RECYCLE_CARRY_KEYS)
    carry["active"][0] = True
    for n in range(3):
        if n == 1:                           # admit b into slot 1
            for k, v in b.items():
                batch[k][1] = v
                tbatch[k][1] = torch.as_tensor(v)
            jfs.clear_carry_slot(jcarry, 1)
            fs.clear_carry_slot(carry, 1)
            jcarry["active"][1] = True
            carry["active"][1] = True
        jcarry, jout = jstep(params, batch, jcarry)
        jcarry = {k: np.array(v) for k, v in jcarry.items()}
        carry, out = step(model, tbatch, carry)
        for k in ("n_rec", "conv", "active"):
            np.testing.assert_array_equal(carry[k].numpy(), jcarry[k],
                                          err_msg=f"step {n} {k}")
        np.testing.assert_array_equal(out["n_recycles"].numpy(),
                                      np.asarray(jout["n_recycles"]))
        for k in ("msa0", "z", "x", "sf"):
            np.testing.assert_allclose(to_np(carry[k]), jcarry[k], atol=1e-4,
                                       rtol=0, err_msg=f"step {n} {k}")
        for k in ("coords", "contact_probs", "plddt_logits",
                  "distogram_logits"):
            np.testing.assert_allclose(to_np(out[k]), to_np(jout[k]),
                                       atol=1e-4, rtol=0,
                                       err_msg=f"step {n} {k}")
        np.testing.assert_allclose(to_np(out["plddt"]), to_np(jout["plddt"]),
                                   atol=1e-3, rtol=0)
    np.testing.assert_array_equal(carry["n_rec"].numpy(), [3, 2])
    assert np.abs(to_np(carry["x"])).max() > 0.1       # a real structure


@pytest.fixture(scope="module")
def engine(models):
    _, model = models
    return FoldEngine(PCFG, model, buckets=[fs.Bucket(*b) for b in BUCKETS],
                      micro_batch=2, max_recycle=MAX_RECYCLE, tol=0.0,
                      dtype=torch.float32, device="cpu")


def _requests(req_cls=FoldRequest):
    shapes = [(6, 4, 5), (12, 6, 10), (8, 3, 6), (16, 8, 12), (5, 4, 4)]
    return [req_cls(rid=i, features=_features(i, *s), arrival_s=0.6 * i,
                    deadline_s=None if i % 2 else 0.6 * i + 5.0,
                    priority=int(i == 4))
            for i, s in enumerate(shapes)]


def _serve(eng, reqs, clock=VirtualClock, **kw):
    costs = dict(zip(eng.buckets, COSTS))
    return eng.serve([dataclasses.replace(r) for r in reqs], clock=clock(),
                     step_cost=costs, **kw)


def test_serve_continuous_equals_fifo_and_run(engine):
    reqs = _requests()
    cont = _serve(engine, reqs, policy="continuous", cache=ResultCache(4))
    assert engine.last_stats["call"] == "serve"
    assert engine.last_report["completed"] == len(reqs)
    fifo = _serve(engine, reqs, policy="fifo")
    done = engine.run(reqs)
    assert engine.last_stats["call"] == "run"
    assert sorted(cont) == sorted(fifo) == sorted(done) == list(range(5))
    for rid in done:
        np.testing.assert_array_equal(cont[rid].coords, fifo[rid].coords)
        np.testing.assert_array_equal(cont[rid].plddt, fifo[rid].plddt)
        assert cont[rid].n_recycles == fifo[rid].n_recycles \
            == done[rid].n_recycles == MAX_RECYCLE
        np.testing.assert_allclose(cont[rid].coords, done[rid].coords,
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(cont[rid].plddt, done[rid].plddt,
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(cont[rid].contact_probs,
                                   done[rid].contact_probs, atol=1e-4, rtol=0)
    assert any(cont[r].finish_s != fifo[r].finish_s for r in done)


def test_admission_leaves_the_request_in_flight_unchanged(engine):
    a, b = _requests()[0], _requests()[2]       # both in the small bucket
    a.arrival_s, b.arrival_s = 0.0, 1.5         # b lands after a's step 2
    solo = _serve(engine, [a])
    both = _serve(engine, [a, b])
    assert [t["admitted"] for t in engine.last_report["trace"]][:3] == \
        [[0], [], [2]]
    np.testing.assert_array_equal(solo[0].coords, both[0].coords)
    np.testing.assert_array_equal(solo[0].plddt, both[0].plddt)
    assert solo[0].n_recycles == both[0].n_recycles == MAX_RECYCLE
    assert solo[0].finish_s == both[0].finish_s == 3.0


def _ref_recycle_step(params, batch, carry):
    """A stand-in for the reference's jitted recycle step: every active
    slot runs one cycle and nothing converges (tol 0)."""
    carry = {k: np.array(v) for k, v in carry.items()}
    carry["n_rec"] = carry["n_rec"] + (carry["active"] & ~carry["conv"])
    n, r = batch["target_feat"].shape[:2]
    return carry, {"coords": np.zeros((n, r, 3), np.float32),
                   "plddt": np.zeros((n, r), np.float32),
                   "contact_probs": np.zeros((n, r, r), np.float32)}


def _ref_fold_step(params, batch):
    n, r = batch["target_feat"].shape[:2]
    return {"coords": np.zeros((n, r, 3), np.float32),
            "plddt": np.zeros((n, r), np.float32),
            "contact_probs": np.zeros((n, r, r), np.float32),
            "n_recycles": np.full((n,), MAX_RECYCLE, np.int32),
            "converged": np.zeros((n,), bool)}


def test_compile_misses_count_as_the_reference(models, monkeypatch):
    """The same calls on both engines, the reference's steps stubbed (no
    XLA compile; its engine counts a miss where it builds a step)."""
    params, model = models
    monkeypatch.setattr(jfs, "make_recycle_step",
                        lambda *a, **k: _ref_recycle_step)
    monkeypatch.setattr(jfs, "make_fold_step", lambda *a, **k: _ref_fold_step)
    kw = dict(micro_batch=2, max_recycle=MAX_RECYCLE, tol=0.0)
    jeng = JaxFoldEngine(CFG, params, buckets=[jfs.Bucket(*b)
                                               for b in BUCKETS],
                         dtype=jnp.float32, **kw)
    eng = FoldEngine(PCFG, model, buckets=[fs.Bucket(*b) for b in BUCKETS],
                     dtype=torch.float32, device="cpu", **kw)
    reqs, jreqs = _requests(), _requests(JaxFoldRequest)
    calls = [(lambda e, rs, clk: _serve(e, rs[:3], clk, policy="fifo")),
             (lambda e, rs, clk: _serve(e, rs, clk, policy="continuous")),
             (lambda e, rs, clk: e.run(rs[:2])),
             (lambda e, rs, clk: e.run(rs))]
    misses = []
    for call in calls:
        call(jeng, jreqs, JaxClock)
        call(eng, reqs, VirtualClock)
        misses.append((eng.compile_misses, jeng.compile_misses))
    assert all(got == want for got, want in misses), misses
    # the recycle kind's two buckets, then the fold kind's: 2x the table
    assert [got for got, _ in misses] == [2, 2, 4, 4]


def test_calibrate_step_costs_gives_a_median_per_bucket(engine):
    costs = calibrate_step_costs(engine, _requests())
    assert sorted(costs) == sorted(engine.buckets)
    walls = engine.last_report["step_wall_s"]
    assert all(costs[b] == float(np.median(walls[b])) > 0 for b in costs)


def test_serve_under_data_and_dap_plans_matches_one_device():
    """Two gloo ranks (``torch_serve_worker.run``): the long bucket under
    dap=2, the short one under data=2 and then on one device per rank,
    measured step costs agreed across all the engine's ranks, so both
    ranks take the same schedule; their folds equal a one-device engine's
    within 1e-4, and featurize threads are refused."""
    cfg = dataclasses.replace(PCFG, max_recycle=2)
    feats = [_features(0, 6, 4, 5), _features(1, 16, 8, 12),
             _features(2, 8, 3, 6)]
    inp = {"cfg": cfg, "buckets": BUCKETS, "max_recycle": 2,
           "feats": feats}
    got = ranks.spawn(serve_worker.run, 2, inp, device_type="cpu",
                      timeout_s=120, threads=1)
    want = serve_worker.engine(cfg, BUCKETS, 2).serve(
        serve_worker.requests(feats), step_cost=lambda b: 1.0)
    for g in got:
        assert "featurize_workers > 0" in g["workers_error"]
        assert "dp=2 bp=1 dap=1" in g["data"]["plans"][8]
        assert "dp=1 bp=1 dap=1" in g["replicated"]["plans"][8]
        for case in ("data", "replicated"):
            assert "dp=1 bp=1 dap=2" in g[case]["plans"][16]
    for case in ("data", "replicated"):
        for g in got:
            res = g[case]["results"]
            assert sorted(res) == sorted(want) == [0, 1, 2]
            for rid, (xyz, plddt, n_rec, _) in res.items():
                assert n_rec == want[rid].n_recycles == 2
                np.testing.assert_allclose(xyz, want[rid].coords, atol=1e-4,
                                           rtol=0)
                np.testing.assert_allclose(plddt, want[rid].plddt,
                                           atol=1e-4, rtol=0)
        a, b = got[0][case], got[1][case]
        assert a["trace"] == b["trace"], case
        assert a["step_wall_s"] == b["step_wall_s"], case
        assert {rid: r[3] for rid, r in a["results"].items()} == \
            {rid: r[3] for rid, r in b["results"].items()}, case


def test_every_cell_validates_its_bucket(models, monkeypatch):
    """A plan's build is cached, so validating in the build checks only
    the first bucket built; each cell validates its own."""
    _, model = models

    def build(self, mesh=None, *, cfg=None, device=None):
        self.validate(cfg)
        return plan_lib._build(ParallelPlan(), None, cfg,
                               torch.device("cpu"))

    monkeypatch.setattr(ParallelPlan, "build", build)
    ok, bad = fs.Bucket(8, 4, 6), fs.Bucket(9, 4, 6)
    eng = FoldEngine(PCFG, model, buckets=[ok, bad], long_threshold=1,
                     long_plan=ParallelPlan(dap=2), micro_batch=2,
                     max_recycle=MAX_RECYCLE, dtype=torch.float32,
                     device="cpu")
    assert eng.plan_for(bad) is eng.plan_for(ok) is eng.long_plan
    eng.step_for(ok)
    eng.recycle_step_for(ok)
    for make in (eng.step_for, eng.recycle_step_for):
        with pytest.raises(PlanError, match="does not divide cfg.n_res=9"):
            make(bad)
