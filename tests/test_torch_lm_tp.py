"""Tensor parallelism over ``model`` (``parallel.tensor``) for the six LM
families: the port's train step, prefill and decode over ("data",
"model") meshes against the JAX package's own GSPMD programs on the same
meshes, and against the port's one-device step.

The reference runs in fresh interpreters with four fake XLA host devices
(``torch_lm_tp_reference.py``, several at once), on a mesh built by hand
(``jax.sharding.Mesh``, Auto axes; ``jax.make_mesh``'s Explicit axes are
rejected by the reference's ``with_sharding_constraint``).  The port runs
on four gloo CPU ranks in one spawn (``torch_lm_tp_worker.run``) while
they do.  Weights: the port's init plus numpy noise in the reference's
layout (``torch_util.lm_tree``), each rank loading its slices.  Every
family at its reduced widths, fp32 policy on both sides, at (data, model)
in {(1, 2), (1, 4), (2, 2)} (``fsdp=True`` on (2, 2)), and three
overrides of glm4-9b at (1, 4): query heads that 'model' cuts inside a
head (``n_head=6``: 1.5 heads a rank), an odd vocabulary (127, left
replicated), and ``factored_decode`` (``model`` as (kvh 2, brep 2)).

Beside them: the conjugate pair's gradients, the collectives a dense
step, prefill and decode step run, ``DecodeEngine(mesh=)`` against the
one-device engine (fp32), a (pod, data, model) FSDP step, the layouts
that raise, both launchers' ``--tp`` (their command lines, run while the
ranks do) and the dry run's tensor-parallel trace.

Tolerances (``tests/test_torch_lm_fsdp.py``'s): loss and gradient norm
within 1e-5 relative, each gathered updated leaf within 1e-4 of the
reference step's largest move; logits within 1e-4 of the largest logit
(at least 1), greedy tokens equal.
"""
import dataclasses
import os
import pickle
import re
import subprocess
import sys
import threading
import types

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.nn.partition import make_param_specs
from repro.train.trainstep import sanitize_spec

from repro_torch import bridge
from repro_torch.models import get_model

import torch_lm_tp_worker as worker
from test_torch_lm_model import port_cfg
from torch_util import lm_tree

ARCHS = ("glm4-9b", "qwen2-moe-a2.7b", "mamba2-2.7b", "zamba2-7b",
         "whisper-medium", "internvl2-26b")
MESHES = ((1, 2), (1, 4), (2, 2))
OVERRIDES = {"split_head": {"n_head": 6}, "odd_vocab": {"vocab": 127},
             "factored": {"factored_decode": True, "uniform_decode": True}}
N, S = 4, 8                 # training batch
B, PROMPT, DECODE = 2, 6, 4
REF_PROCS = 4
TIMEOUT_S = 300
HERE = os.path.dirname(os.path.abspath(__file__))


def _jax_cfg(case):
    return dataclasses.replace(jax_smoke_config(case["arch"],
                                                scan_layers=True),
                               **case["overrides"])


def _arrays(cfg, n, s, seed, labels=True):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (n, s)).astype(np.int32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab, (n, s)).astype(np.int32)
    key = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    if key:
        out[key] = rng.standard_normal(
            (n, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


def _cases():
    cases = {}
    for arch in ARCHS:
        for shape in MESHES:
            cases[f"{arch}@{shape[0]}x{shape[1]}"] = {
                "arch": arch, "mesh": shape, "params": arch,
                "overrides": {"fsdp": shape[0] > 1}}
    for name, ov in OVERRIDES.items():
        cases[name] = {"arch": "glm4-9b", "mesh": (1, 4),
                       "params": "glm4-9b" if name == "factored" else name,
                       "overrides": {"fsdp": False, **ov}}
    params = {}
    for name, case in cases.items():
        cfg = _jax_cfg(case)
        if case["params"] not in params:
            pcfg = port_cfg(cfg)
            model = get_model(pcfg).init_params(pcfg, seed=0, device="cpu")
            params[case["params"]] = lm_tree(model, cfg, 1)
        # one batch a weight set: the one-device step serves its cases
        i = list(params).index(case["params"])
        n_front = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
        case.update(batch=_arrays(cfg, N, S, 10 + i),
                    prompt=_arrays(cfg, B, PROMPT, 50 + i, labels=False),
                    max_len=n_front + PROMPT + DECODE + 2, decode=DECODE,
                    lr=0.5, clip=1.0)
    return cases, params


# the engine on a mesh: slots' rows over 'data', the factored plan's rows
# over 'brep' and KV heads over 'kvh', the hybrid's conv cache beside KV
# heads gathered for a replicated cache
ENGINE = ["glm4-9b@2x2", "factored", "zamba2-7b@1x4"]


def _engine_cases(cases):
    """The engine's cases: its slots hold prompts of unequal lengths, so
    no ``uniform_decode`` (which writes every row at row 0's length)."""
    out = {}
    for n in ENGINE:
        case = {k: cases[n][k] for k in ("arch", "mesh", "params")}
        case["overrides"] = {k: v for k, v in cases[n]["overrides"].items()
                             if k != "uniform_decode"}
        out[n] = case
    return out


def _reference(cases, params, tmp):
    """Start the reference's processes (each a share of the cases)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_cpu_multi_thread_eigen=false",
               PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    names = sorted(cases, key=lambda n: cases[n]["arch"])
    procs = []
    for k in range(REF_PROCS):
        part = {n: cases[n] for n in names[k::REF_PROCS]}
        src, dst = tmp / f"in{k}.pkl", tmp / f"out{k}.pkl"
        with open(src, "wb") as f:
            pickle.dump({"cases": part, "params": params}, f)
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_lm_tp_reference.py"),
             str(src), str(dst)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT), dst))
    return procs


LAUNCH = {
    "train": ["repro_torch.launch.train", "--arch", "glm4-9b", "--smoke",
              "--device", "cpu", "--steps", "2", "--batch", "2", "--seq",
              "16"],
    "serve": ["repro_torch.launch.serve", "--arch", "glm4-9b", "--smoke",
              "--device", "cpu", "--requests", "3", "--slots", "2",
              "--max-new", "4", "--prompt-len", "8", "--max-len", "32"]}
LAUNCH["train_tp"] = LAUNCH["train"] + ["--devices", "4", "--tp", "2"]
LAUNCH["serve_tp"] = LAUNCH["serve"] + ["--devices", "2", "--tp", "2"]


def _launch(out: dict):
    """The launchers' command lines, one after another: {name: stdout}."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "..", "src"), os.environ.get("PYTHONPATH", "")]))
    for name, argv in LAUNCH.items():
        proc = subprocess.run([sys.executable, "-m", *argv], env=env,
                              capture_output=True, text=True,
                              timeout=TIMEOUT_S)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[name] = proc.stdout


def _collect(procs):
    out = {}
    for proc, dst in procs:
        log, _ = proc.communicate(timeout=TIMEOUT_S)
        assert proc.returncode == 0, log.decode()[-3000:]
        with open(dst, "rb") as f:
            out.update(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(cases, weights, the reference's results, the port's ranks', the
    port's one-device runs, the launchers' outputs).  The launchers run
    from the command line meanwhile, one after another."""
    from repro_torch.parallel import ranks
    cases, params = _cases()
    procs = _reference(cases, params, tmp_path_factory.mktemp("tp_ref"))
    inp = {"cases": cases, "params": params, "meshes": MESHES,
           "engine": _engine_cases(cases), "pod": cases["glm4-9b@2x2"]}
    box, launched = {}, {}

    def launch():
        try:
            _launch(launched)
        except BaseException as e:      # raised below, in the test
            box["error"] = e
    launcher = threading.Thread(target=launch)
    launcher.start()

    def ranks_run():
        try:
            box["port"] = ranks.spawn(worker.run, 4, inp, device_type="cpu",
                                      timeout_s=TIMEOUT_S, threads=1)
        except BaseException as e:      # raised below, in the test
            box["error"] = e
    thread = threading.Thread(target=ranks_run)
    thread.start()
    try:
        one = worker.one_device(inp)    # meanwhile, in this process
    finally:
        thread.join()
        launcher.join()
        ref = _collect(procs)
    if "error" in box:
        raise box["error"]
    return cases, params, ref, box["port"], one, launched


def _rank(shape, i, j):
    return i * shape[1] + j


def _one(world, name):
    return world[4]["one"][worker.one_key(world[0][name])]


CASES = [f"{a}@{d}x{m}" for a in ARCHS for d, m in MESHES] + list(OVERRIDES)


def _assert_step(got_loss, got_norm, got, want_loss, want_norm, want, p0):
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    assert abs(got_norm - want_norm) <= 1e-5 * want_norm
    move = max(np.abs(want[k] - np.asarray(p0[k])).max() for k in want)
    assert move > 0 and set(got) == set(want)
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= 1e-4 * move, k


@pytest.mark.parametrize("name", CASES)
def test_train_step_matches_the_reference_gspmd_step(world, name):
    """The loss and gradient norm on every rank, and every gathered
    updated leaf, against the reference's step on the same mesh and
    against the port's one-device step; the clip is active."""
    cases, params, ref, port = world[:4]
    case = cases[name]
    shape = case["mesh"]
    p0 = bridge.flatten(params[case["params"]])
    r0 = port[0]["cases"][name]
    for rank in range(shape[0] * shape[1]):
        res = port[rank]["cases"][name]
        assert (res["loss"], res["grad_norm"]) == (r0["loss"],
                                                   r0["grad_norm"])
    assert ref[name]["grad_norm"] > case["clip"]
    _assert_step(r0["loss"], r0["grad_norm"], r0["params"], ref[name]["loss"],
                 ref[name]["grad_norm"], ref[name]["params"], p0)
    one = _one(world, name)
    _assert_step(r0["loss"], r0["grad_norm"], r0["params"], one["loss"],
                 one["grad_norm"], one["params"], p0)


@pytest.mark.parametrize("name", CASES)
def test_prefill_and_decode_logits_match_the_reference(world, name):
    """The prefill's last-position logits and each decode step's, over the
    whole vocabulary, on each rank's rows, against the reference's prefill
    and decode on the same mesh and the port's one device; the greedy
    tokens each side fed itself (the port's taken over the split
    vocabulary with the reference's lowest-index tie-break) are equal."""
    cases, _, ref, port = world[:4]
    case = cases[name]
    d, m = case["mesh"]
    want, one = ref[name]["logits"], _one(world, name)
    tol = 1e-4 * max(1.0, np.abs(want).max())
    rows = B // d
    for i in range(d):
        for j in range(m):
            res = port[_rank(case["mesh"], i, j)]["cases"][name]
            sl = slice(i * rows, (i + 1) * rows)
            assert res["logits"].shape == want[sl].shape
            assert np.abs(res["logits"] - want[sl]).max() <= tol, (i, j)
            assert np.abs(res["logits"] - one["logits"][sl]).max() <= tol
            np.testing.assert_array_equal(res["tokens"], ref[name]["tokens"])
    np.testing.assert_array_equal(one["tokens"], ref[name]["tokens"])


def _flat(tree, prefix=""):
    """{dotted path: leaf} of a nested dict (a spec is a leaf)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = getattr(v, "shape", v)
    return out


def _want_local(case):
    """{port key: this rank's shape} for each rank of the case's mesh, from
    the reference's own specs (``make_param_specs`` over ``jax.eval_shape``
    of its init, ``sanitize_spec``)."""
    cfg = _jax_cfg(case)
    model = jax_get_model(cfg)
    shapes = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0),
                                                      cfg))
    specs = make_param_specs(shapes, model.partition_rules(cfg))
    d, m = case["mesh"]
    mesh = types.SimpleNamespace(shape={"data": d, "model": m})
    flat_shapes, flat_specs = _flat(shapes), _flat(specs)
    out = {}
    for key, shape in flat_shapes.items():
        spec = sanitize_spec(flat_specs[key], shape, mesh)
        cuts = []
        for i, entry in enumerate(tuple(spec) + (None,) * len(shape)):
            names = entry if isinstance(entry, tuple) else (entry,)
            cuts.append([n for n in names if n is not None])
        head, _, rest = key.partition(".")
        if head in bridge.LM_STACKED:
            assert not cuts[0], key
            keys = [f"{head}.{n}.{rest}" for n in range(shape[0])]
            shape, cuts = shape[1:], cuts[1:]
        else:
            keys = [key]
        for k in keys:
            out[k] = (tuple(shape), cuts[:len(shape)])
    return out


@pytest.mark.parametrize("name", CASES)
def test_each_rank_holds_its_sanitized_slice(world, name):
    """Every parameter and moment a rank holds has the shape of its slice
    by the reference's sanitized spec, and holds the elements of that
    slice (their sum and sum of squares)."""
    cases, params, _, port = world[:4]
    case = cases[name]
    d, m = case["mesh"]
    full = bridge.params_to_state_dict(params[case["params"]],
                                       stacked=bridge.LM_STACKED)
    want = _want_local(case)
    for i in range(d):
        for j in range(m):
            res = port[_rank(case["mesh"], i, j)]["cases"][name]
            coord = {"data": i, "model": j}
            assert set(res["local"]) == set(want) == set(res["mu_local"])
            for k, (shape, cuts) in want.items():
                a = full[k].numpy().astype(np.float64)
                for dim, names in enumerate(cuts):
                    for n in names:
                        a = np.split(a, {"data": d, "model": m}[n],
                                     axis=dim)[coord[n]]
                assert res["local"][k] == a.shape == res["mu_local"][k], k
                s, sq = res["sums"][k]
                assert abs(s - a.sum()) <= 1e-9 * max(1.0, np.abs(a).sum())
                assert abs(sq - np.square(a).sum()) <= 1e-9 * max(
                    1.0, np.square(a).sum()), k




@pytest.mark.parametrize("name", ["glm4-9b@1x4", "whisper-medium@2x2"])
def test_bytes_held_sums_a_ranks_parameters_by_kind(world, name):
    """``Layout.bytes_held``: four disjoint kinds (split over 'data' alone,
    over 'model' alone, over both, over neither) that sum to the rank's
    parameter bytes (phase 11d and the launcher sum them); a (1, m) mesh
    splits nothing over 'data', a (2, 2) FSDP mesh splits leaves over
    both."""
    cases, _, _, port = world[:4]
    d, m = cases[name]["mesh"]
    for rank in range(d * m):
        res = port[rank]["cases"][name]
        held = res["held"]
        assert sum(held.values()) == 4 * sum(
            int(np.prod(s)) for s in res["local"].values())
        assert held["model_split"] + held["both"] > 0
        assert held["replicated"] > 0
        if d == 1:
            assert held["sharded"] == held["both"] == 0
        else:
            assert held["both"] > 0 and held["sharded"] >= 0


def test_conjugate_pair_gradients(world):
    """Two ranks, rank r feeding x * (r + 1), weighted by w: ``reduce_from``
    sums in the forward only (the gradient is the rank's own, (r + 1) w),
    ``copy_to`` in the backward only (the two ranks' cotangents summed,
    2 (r + 1) w); ``psum`` in both, so a row-parallel output summed by it
    would take 2 (r + 1) w, the extent times too much.  Each counts one
    all-reduce a pass it runs."""
    port = world[3]
    w = np.array([1.0, -2.0, 0.5], np.float32)
    x = np.arange(1.0, 4.0, dtype=np.float32)
    for r in (0, 1):
        pair = port[r]["pair"]
        np.testing.assert_allclose(pair["reduce_from"]["y"], 3 * x)
        np.testing.assert_allclose(pair["reduce_from"]["grad"], (r + 1) * w)
        np.testing.assert_allclose(pair["copy_to"]["y"], (r + 1) * x)
        np.testing.assert_allclose(pair["copy_to"]["grad"], 2 * (r + 1) * w)
        np.testing.assert_allclose(pair["psum"]["grad"], 2 * (r + 1) * w)
        assert [pair[k]["psum"] for k in ("reduce_from", "copy_to",
                                          "psum")] == [1, 1, 2]


@pytest.mark.parametrize("name", CASES)
def test_every_rank_runs_the_same_collectives(world, name):
    """The train step's, the prefill's and a decode step's collective
    counts are the same on every rank of the mesh."""
    cases, _, _, port = world[:4]
    d, m = cases[name]["mesh"]
    r0 = port[0]["cases"][name]
    for rank in range(1, d * m):
        res = port[rank]["cases"][name]
        assert res["counts"] == r0["counts"]
        assert res["serve_counts"] == r0["serve_counts"]


@pytest.mark.parametrize("name", ["glm4-9b@1x2", "glm4-9b@1x4"])
def test_dense_collective_counts(world, name):
    """glm4-9b (L = 2 layers, 4 / 2 heads) at model 2 and 4: the step's
    all-reduces are the vocab-parallel lookup's, each layer's two
    row-parallel outputs', the cross entropy's (forward), each layer's two
    column-parallel inputs' and the head's (backward), and the norm's:
    4 L + 4, one pmax (the cross entropy's max).  At model 4 the KV heads
    (64 columns a rank, half a head) are gathered: 2 L all-gathers, each
    reduce-scattered backward.  The prefill and a decode step all-reduce
    2 L + 1 times and, the cache being replicated (2 KV heads), gather
    every layer's k and v projections for it."""
    cases, _, _, port = world[:4]
    n_layer, m = 2, cases[name]["mesh"][1]
    res = port[0]["cases"][name]
    kv = 2 * n_layer if m == 4 else 0
    assert res["counts"]["psum"] == 4 * n_layer + 4
    assert res["counts"]["pmax"] == 1
    assert res["counts"]["all_gather"] == res["counts"]["reduce_scatter"] \
        == kv
    for step in ("prefill", "decode"):
        c = res["serve_counts"][step]
        assert c["psum"] == 2 * n_layer + 1
        assert c["all_gather"] == 2 * n_layer + (kv if step == "prefill"
                                                 else 0)


def test_pod_axis_replicates_the_fsdp_step(world):
    """glm4-9b (``fsdp=True``) over (pod 2, data 2, model 1), the batch
    over both data axes (as the dry run's two-pod cells): leaves shard over
    'data' alone and their gradients are summed over 'pod' too; the loss,
    the gradient norm and every updated leaf are the one-device step's
    (the (2, 2) case's, same weights and batch)."""
    cases, params, _, port = world[:4]
    name = "glm4-9b@2x2"
    p0 = bridge.flatten(params[cases[name]["params"]])
    one = _one(world, name)
    r0 = port[0]["pod"]
    assert any(d is not None for d in r0["dims"].values())
    for rank in range(4):
        assert (port[rank]["pod"]["loss"], port[rank]["pod"]["grad_norm"]) \
            == (r0["loss"], r0["grad_norm"])
    assert r0["counts"]["reduce_scatter"] > 0
    _assert_step(r0["loss"], r0["grad_norm"], r0["params"], one["loss"],
                 one["grad_norm"], one["params"], p0)


def test_a_layout_the_port_cannot_compute_raises_naming_the_leaf(world):
    port = world[3]
    for r in range(4):
        msgs = port[r]["refusals"]
        assert "layers.0.x.w" in msgs["both_axes"]
        assert "layers.0.mlp.w_gate.w" in msgs["uneven"]


@pytest.mark.parametrize("name", ENGINE)
def test_decode_engine_on_a_mesh_serves_the_one_device_tokens(world, name):
    """``DecodeEngine(mesh=...)`` (three requests on two slots, one slot
    refilled) gives every rank the one-device engine's greedy tokens
    (fp32 policy)."""
    cases, _, _, port = world[:4]
    d, m = cases[name]["mesh"]
    want = world[4]["engine"][name]
    assert sorted(want) == [0, 1, 2]
    for rank in range(d * m):
        assert port[rank]["engine"][name] == want


def _loss_lines(out: str) -> dict:
    """{step: loss} of the train launcher's step lines."""
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^step\s+(\d+)\s+loss\s+([-\d.]+)", out, re.M)}


def _token_lines(out: str) -> dict:
    """{request: tokens} of the serve launcher's request lines."""
    return {int(m.group(1)): [int(t) for t in m.group(2).split(",")]
            for m in re.finditer(r"^\s+req (\d+): \[([\d, ]+)\]", out,
                                 re.M)}


def test_train_launcher_tp_matches_one_device(world):
    """``launch.train --devices 4 --tp 2`` (a (2, 2) mesh) against
    ``--devices 1``: both losses (printed to 4 decimals) within 1e-3
    relative (bf16: the ranks' row-parallel partial products are rounded
    before their sum)."""
    one, four = (_loss_lines(world[5][k]) for k in ("train", "train_tp"))
    assert "tensor parallel: 2 over 'model'" in world[5]["train_tp"]
    assert sorted(one) == sorted(four) == [0, 1]
    for s in (0, 1):
        assert abs(four[s] - one[s]) <= 1e-3 * abs(one[s])


def test_serve_launcher_tp_serves_every_request(world):
    """``launch.serve --devices 2 --tp 2``: rank 0 reports the mesh and
    every request's tokens; the first (the prefill's greedy token over the
    split vocabulary) equal the one-device launcher's."""
    out = world[5]["serve_tp"]
    assert "mesh (data 1, model 2)" in out
    one, two = _token_lines(world[5]["serve"]), _token_lines(out)
    assert sorted(one) == sorted(two) == [0, 1, 2]
    for rid in one:
        assert len(two[rid]) == len(one[rid]) == 4
        assert two[rid][0] == one[rid][0]


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_dry_run_traces_a_tensor_parallel_cell(shape, monkeypatch):
    """``launch.dryrun.run_lm_cell`` on a (2, 2) virtual mesh (glm4-9b's
    reduced widths): rank 0's tensor-parallel step traced, its all-reduces
    over 'model' recorded by axis; the state or the cache it holds is the
    sized one (less the optimizer's step, a host integer in the port)."""
    from repro_torch import configs as tconfigs
    from repro_torch.launch import dryrun as D
    monkeypatch.setenv("REPRO_DRYRUN_MESH", "2x2")
    cfg = tconfigs.get_smoke_config("glm4-9b")
    rec = D.run_lm_cell("glm4-9b", shape, False, cfg_override=cfg,
                        probes=False)
    assert rec["status"] == "ok" and rec["mesh_axes"] == {"data": 2,
                                                          "model": 2}
    by_axis = rec["full"]["collectives_by_axis"]
    assert by_axis["model"]["all-reduce"]["count"] > 0
    step = 4 if shape == "train_4k" else 0
    assert rec["full"]["memory"]["alias_bytes"] == \
        rec["sized"]["alias_bytes"] - step
