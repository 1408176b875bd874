"""The port's serving path end to end against the JAX package, at af2_tiny:
``predict`` on a padded batch, ``FoldEngine.run`` on a mixed-length queue,
``TrainRunner.evaluate`` (which serves through a FoldEngine), and the
launcher in a subprocess.

Both sides get the same JAX params (the init rules' tree, perturbed as
``tests/util.py::randomize`` does, in numpy) through the bridge, and the
same numpy features.  JAX runs its ``chunked`` impls, the port its kernel
impls (plain versions on CPU tensors), everything in fp32.  Tolerance
1e-4 on coordinates and logits, 1e-3 on pLDDT (0..100 scale): the
reference's own padded-vs-unpadded pins (tests/test_fold_engine.py); a
fold chains two recycles of the whole trunk and eight IPA layers.
Recycle counts and convergence flags must match exactly.
"""
import copy
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heads as jheads
from repro.core import model as jaf2
from repro.core.config import af2_tiny
from repro.serve import FoldEngine as JaxFoldEngine
from repro.serve import FoldRequest as JaxFoldRequest
from repro.serve.fold_steps import Bucket as JaxBucket

from repro_torch.core import model as taf2
from repro_torch.data.protein import protein_batch
from repro_torch.data.synthetic import fold_features
from repro_torch.serve import fold_steps as fs
from repro_torch.serve.fold_engine import FoldEngine, FoldRequest
from repro_torch.train.trainer import TrainRunner

from torch_util import af2_tree, load_into, port_cfg, randomize_np, to_np

CFG = af2_tiny()
PCFG = port_cfg(CFG)


@pytest.fixture(scope="module")
def init_params():
    return af2_tree(CFG)


def _models(init_params, scale, backbone_gain=1.0):
    params = randomize_np(init_params, 1, scale)
    params["structure"]["backbone_update"]["w"] *= backbone_gain
    return params, load_into(taf2.AlphaFold2(PCFG, device="cpu"), params)


@pytest.fixture(scope="module")
def models(init_params):
    return _models(init_params, 0.02)


def _features(rid, r, s, se):
    c = dataclasses.replace(CFG, n_res=r, n_seq=s, n_extra_seq=se)
    return fold_features(np.random.default_rng([7, rid]), c)


def _padded_batch():
    bucket = fs.Bucket(CFG.n_res, CFG.n_seq, CFG.n_extra_seq)
    feats = [_features(0, 16, 8, 12), _features(1, 11, 6, 9)]
    return fs.stack_padded([fs.pad_to_bucket(f, bucket) for f in feats], 2)


def _jax_predict(params, batch, **kw):
    return jax.jit(lambda p, b: jaf2.predict(p, CFG, b, dtype=jnp.float32,
                                             **kw))(params, batch)


def _both(models, batch, **kw):
    params, model = models
    want = _jax_predict(params, batch, **kw)
    got = taf2.predict(model, PCFG, batch, dtype=torch.float32, **kw)
    return got, want


@pytest.fixture(scope="module")
def tol0_want(models):
    """The JAX package's fold of the padded batch (max_recycle 2, tol 0):
    computed once for every port config it is held against."""
    return _jax_predict(models[0], _padded_batch(), max_recycle=2, tol=0.0)


@pytest.mark.parametrize("impls", ["kernels", "defaults"])
def test_predict_matches_jax_tol0(models, tol0_want, impls):
    """The port at its kernel impls (their plain versions here), and at the
    config's own defaults (chunked attention and triangle updates, fused
    OPM), which are the impls the JAX side runs."""
    cfg = PCFG if impls == "kernels" else port_cfg(CFG, kernels=False)
    got = taf2.predict(models[1], cfg, _padded_batch(), dtype=torch.float32,
                       max_recycle=2, tol=0.0)
    want = tol0_want
    assert set(got) == set(fs.PREDICT_OUTPUT_KEYS) == set(want)
    assert np.abs(to_np(want["coords"])).max() > 0.1     # a real structure
    for key in ("coords", "plddt_logits", "distogram_logits",
                "contact_probs"):
        np.testing.assert_allclose(to_np(got[key]), to_np(want[key]),
                                   atol=1e-4, rtol=0, err_msg=key)
    np.testing.assert_allclose(to_np(got["plddt"]), to_np(want["plddt"]),
                               atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got["n_recycles"].numpy(), [2, 2])
    np.testing.assert_array_equal(got["converged"].numpy(), [False, False])


def _convergence(fracs, tol, max_recycle):
    """predict()'s rule on one sample's per-cycle bin-change fractions:
    (n_recycles, converged)."""
    for k, f in enumerate(fracs[:max_recycle]):
        if f < tol:
            return k + 1, True
    return max_recycle, False


def test_predict_early_exit_matches_jax(init_params):
    """With a tolerance that gives the two samples different recycle
    schedules (self-calibrated from the trajectory, as tests/test_predict.py
    does), JAX and the port take the same schedule.  Larger weights and a
    10x backbone update make the fold move across distance bins between
    cycles (at the default perturbation every distance stays in bin 0)."""
    models = _models(init_params, 0.1, backbone_gain=10.0)
    params, model = models
    batch = _padded_batch()
    pm = np.asarray(jaf2.fold_pair_mask(batch)[0])
    coords = [torch.zeros((2, CFG.n_res, 3))] + [
        taf2.predict(model, PCFG, batch, max_recycle=n,
                     dtype=torch.float32)["coords"] for n in (1, 2, 3)]
    bins = [taf2.recycle_distance_bins(c).numpy() for c in coords]
    fracs = [[float(((bins[k][i] != bins[k + 1][i]) * pm[i]).sum()
                    / max(pm[i].sum(), 1.0)) for k in range(3)]
             for i in range(2)]
    cands = sorted({f for fr in fracs for f in fr})
    mids = [(a + b) / 2 for a, b in zip(cands, cands[1:])]
    tol = next((m for m in mids if _convergence(fracs[0], m, 3)[0]
                != _convergence(fracs[1], m, 3)[0]), None)
    assert tol is not None, f"indistinguishable schedules: {fracs}"
    got, want = _both(models, batch, max_recycle=3, tol=tol)
    np.testing.assert_array_equal(got["n_recycles"].numpy(),
                                  np.asarray(want["n_recycles"]))
    np.testing.assert_array_equal(got["converged"].numpy(),
                                  np.asarray(want["converged"]))
    assert len(set(np.asarray(want["n_recycles"]).tolist())) == 2
    np.testing.assert_allclose(to_np(got["coords"]), to_np(want["coords"]),
                               atol=1e-4, rtol=0)


def test_fold_engine_matches_jax_engine(models):
    params, model = models
    shapes = [(6, 4, 5), (12, 6, 10), (8, 3, 6), (16, 8, 12), (5, 4, 4)]
    feats = [_features(i, *s) for i, s in enumerate(shapes)]
    buckets = [(8, 4, 6), (16, 8, 12)]
    kw = dict(micro_batch=2, max_recycle=2, tol=0.0)
    jeng = JaxFoldEngine(CFG, params, dtype=jnp.float32,
                         buckets=[JaxBucket(*b) for b in buckets], **kw)
    teng = FoldEngine(CFG, model, buckets=[fs.Bucket(*b) for b in buckets],
                      dtype=torch.float32, device="cpu", **kw)
    want = jeng.run([JaxFoldRequest(rid=i, features=f)
                     for i, f in enumerate(feats)])
    got = teng.run([FoldRequest(rid=i, features=f)
                    for i, f in enumerate(feats)])
    assert sorted(got) == sorted(want) == list(range(len(feats)))
    assert teng.compile_misses == 2 and teng.last_stats["steps"] == 3
    for rid, (r, _, _) in enumerate(shapes):
        assert got[rid].coords.shape == (r, 3)
        assert got[rid].bucket.n_res == want[rid].bucket.n_res
        np.testing.assert_allclose(got[rid].coords, want[rid].coords,
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(got[rid].plddt, want[rid].plddt,
                                   atol=1e-3, rtol=0)
        assert got[rid].n_recycles == want[rid].n_recycles == 2


def test_trainrunner_evaluate_matches_jax_predict_and_lddt(models):
    """``TrainRunner.evaluate`` (EMA weights, the held-out batch, tol 0,
    ``eval_n_recycle`` cycles through its FoldEngine) against the
    reference's ``predict`` and ``heads.lddt_ca`` on the same weights and
    batch: coordinates within 1e-4, lDDT-Cα within 1e-4 of the
    reference's on its own coordinates.  Before any step the EMA equals
    the model's weights, the randomized ones of ``models``."""
    params, model = models
    runner = TrainRunner(PCFG, seed=3, eval_n_recycle=2, device="cpu",
                         dtype=torch.float32, model=copy.deepcopy(model))
    got = runner.evaluate()
    assert runner.eval_compiles == 1 and runner.train_compiles == 0
    batch = protein_batch(3, 0, runner.eval_batch_size, PCFG, split="val")
    keys = fs.REQUEST_FEATURE_KEYS + ("res_mask",)
    want = _jax_predict(params, {k: batch[k] for k in keys}, max_recycle=2,
                        tol=0.0)
    assert np.abs(to_np(want["coords"])).max() > 0.1     # a real structure
    np.testing.assert_allclose(got["coords"], to_np(want["coords"]),
                               atol=1e-4, rtol=0)
    want_lddt = np.asarray(jax.vmap(jheads.lddt_ca)(
        want["coords"], batch["true_trans"], batch["res_mask"]))
    np.testing.assert_allclose(got["per_sample"], want_lddt, atol=1e-4,
                               rtol=0)
    assert abs(got["lddt_ca"] - float(want_lddt.mean())) <= 1e-4
    np.testing.assert_array_equal(got["true_trans"], batch["true_trans"])
    np.testing.assert_array_equal(got["res_mask"], batch["res_mask"])


def test_engine_defaults_to_cuda_and_raises_without_it(models, monkeypatch):
    _, model = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FoldEngine(CFG, model)


def test_model_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        taf2.AlphaFold2(PCFG)


def _count_trunk_runs(monkeypatch):
    runs = []
    trunk = taf2.run_trunk

    def counted(*a, **kw):
        runs.append(1)
        return trunk(*a, **kw)

    monkeypatch.setattr(taf2, "run_trunk", counted)
    return runs


@pytest.mark.parametrize("tol,max_recycle,want_rec", [(0.0, 2, 2),
                                                       (1.0, 3, 1)])
def test_predict_skips_inactive_slots(models, monkeypatch, tol, max_recycle,
                                      want_rec):
    """An unoccupied micro-batch slot never runs the trunk and does not keep
    the loop going once every occupied slot converged (tol=1 converges after
    one cycle: the diagonal pairs never change bin)."""
    _, model = models
    batch = _padded_batch()
    kw = dict(max_recycle=max_recycle, tol=tol, dtype=torch.float32)
    full = taf2.predict(model, PCFG, batch, **kw)
    runs = _count_trunk_runs(monkeypatch)
    got = taf2.predict(model, PCFG, batch, active=[True, False], **kw)
    assert len(runs) == want_rec
    np.testing.assert_array_equal(got["n_recycles"].numpy(), [want_rec, 0])
    np.testing.assert_array_equal(got["converged"].numpy(), [tol > 0, False])
    torch.testing.assert_close(got["coords"][0], full["coords"][0],
                               atol=0, rtol=0)


def test_fold_engine_skips_filler_slots(models, monkeypatch):
    _, model = models
    eng = FoldEngine(CFG, model, micro_batch=2, max_recycle=2, tol=0.0,
                     dtype=torch.float32, device="cpu")
    runs = _count_trunk_runs(monkeypatch)
    done = eng.run([FoldRequest(rid=0, features=_features(0, 16, 8, 12))])
    assert len(runs) == 2 and done[0].n_recycles == 2
    assert eng.last_stats["steps"] == 1


@pytest.mark.parametrize("args,summary", [
    (["--requests", "3"], r"served 3 folds in "),
    # sustained traffic through FoldEngine.serve: the reference's summary
    (["--arrival-rate", "2", "--cache-capacity", "8", "--duplicates", "0.3"],
     r"served 6/6 folds under 2\.00 req/s \(continuous\): p50 \d+ms p99 "
     r"\d+ms, goodput [\d.]+ req/s, on-time \d+%\n  stages: featurize "
     r"[\d.]+ms \| queue \d+ms \| service \d+ms; utilization \d+%, \d+ "
     r"steps, \d+ compiles, cache hit rate \d+%, \d+ forced admissions")])
def test_launcher_serves_on_cpu(args, summary):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--fold", "tiny",
         "--device", "cpu", *args],
        capture_output=True, text=True, timeout=300,
        # one thread, as the suite's other processes (tests/torch_threads.py)
        env={**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert re.search(summary, proc.stdout), proc.stdout
