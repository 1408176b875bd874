"""The port's Branch Parallelism, DAP (sync and overlapped) and their hybrid
over four gloo rank processes on the CPU, against the JAX package: af2_tiny,
fp32, deterministic.

One module-scoped spawn of four ranks (``torch_parallel_worker.run``, a
rendezvous and collective timeout of 240 s, joined against the same
deadline) serves every test here; while the ranks run, this process
computes the JAX oracles.  The reference's DAP runs in one process under
``jax.vmap(..., axis_name="dap")`` (its collectives' transposes are the
ones ``shard_map`` uses: all_gather -> reduce-scatter, all_to_all -> the
inverse), so its per-rank gradients are the per-instance gradients of a
jitted vmap.

Tolerances: stack outputs 2e-4 (BP) and 3e-4 (DAP, hybrid), as
``tests/test_parallel_equiv.py``; every gradient leaf, and the gradient an
SGD step applied, |port - jax| <= 1e-4 * max(1, max|jax leaf|) +
1e-3 |jax| and losses 1e-5 relative, as ``tests/test_torch_train_loss.py``.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import heads as jheads
from repro.core import model as jaf2
from repro.core.config import af2_tiny
from repro.core import evoformer as jevo
from repro.parallel import dap as jdap
from repro.parallel.grad_sync import compressed_psum_tree
from repro.parallel.plan import _region_exit_fn

from repro_torch import bridge
from repro_torch.data.protein import protein_batch
from repro_torch.parallel import ranks

import torch_parallel_worker as worker
from torch_util import af2_tree, np_tree, port_cfg, randomize_np

CFG = af2_tiny()
CFG_SGD = af2_tiny(n_evoformer=1, n_extra_msa_blocks=1, n_res=8, n_seq=4,
                   n_extra_seq=12, remat="none")
LR = 0.1
TIMEOUT_S = 240
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
# the oracles run once each: compile them with XLA's cheapest backend passes
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)


def _close_grads(got, want, what):
    tol = GRAD_ATOL * max(1.0, float(np.abs(want).max())) + GRAD_RTOL * np.abs(want)
    d = np.abs(got - want)
    assert (d <= tol).all(), f"{what}: max |diff| {d.max()}"


def _jax_loss(params, batch):
    """``loss_fn`` at fp32 (``forward(dtype=float32)``, the same four
    losses and weights), n_recycle 1."""
    out = jaf2.forward(params, CFG_SGD, batch, n_recycle=1, dtype=jnp.float32)
    res_mask = batch["res_mask"].astype(jnp.float32)
    rots, trans = out["traj"]
    return (0.5 * jheads.fape_loss(rots, trans, batch["true_rots"],
                                   batch["true_trans"], res_mask)
            + 0.3 * jheads.distogram_loss(
                jheads.distogram_logits(params["heads"], out["z"]),
                batch["true_trans"], res_mask, n_bins=CFG_SGD.n_distogram_bins)
            + 2.0 * jheads.masked_msa_loss(
                jheads.masked_msa_logits(params["heads"], out["msa"]),
                batch["true_msa"],
                batch["msa_mask_positions"].astype(jnp.float32))
            + 0.01 * jheads.plddt_loss(
                jheads.plddt_logits(params["heads"], out["s_final"]),
                out["trans"], batch["true_trans"], res_mask,
                n_bins=CFG_SGD.n_plddt_bins))


def _vmap_grads(p1, msa, z, block_fn, pre, post, axes):
    """Per-instance gradients of sum(msa_out^2) + sum(z_out^2) through one
    block, under nested vmaps over ``axes`` (outer first)."""
    ev = CFG.evoformer

    def loss(p, m, zz):
        m_l, z_l = pre(m, zz)
        m_l, z_l = jaf2.evoformer_stack(p, ev, 1, m_l, z_l, scan=True,
                                        remat=False, block_fn=block_fn)
        mo, zo = post(m_l, z_l)
        return jnp.sum(mo ** 2) + jnp.sum(zo ** 2)

    fn = lambda _: jax.grad(loss, argnums=(0, 1, 2))(p1, msa, z)
    for name in reversed(axes):
        fn = jax.vmap(fn, axis_name=name)
    x = jnp.zeros((2,) * len(axes))
    return _compile(fn, x)(x)


def _oracles(params, msa, z, params_sgd, pod_grads, opm_rows):
    ev = CFG.evoformer
    o = {}
    opm = jax.tree_util.tree_map(lambda x: x[0], params["evoformer"]["opm"])
    o["opm_naive"] = np.asarray(_compile(
        lambda p, m, r: jevo.outer_product_mean(p, m, row_mask=r),
        opm, msa, opm_rows)(opm, msa, opm_rows))
    o["stack"] = [np.asarray(t) for t in jax.jit(
        lambda p, m, zz: jaf2.evoformer_stack(p, ev, 2, m, zz, scan=True,
                                              remat=False))(
        params["evoformer"], msa, z)]
    p1 = jax.tree_util.tree_map(lambda x: x[:1], params["evoformer"])
    half = _region_exit_fn(0.5)
    o["grads.dap_sync"] = _vmap_grads(
        p1, msa, z, jdap.make_dap_block_fn(), jdap.shard_inputs,
        lambda m, zz: half(*jdap.unshard_outputs(m, zz)), ("dap",))
    batch = protein_batch(0, 0, 2, port_cfg(CFG_SGD))
    samples = [{k: jnp.asarray(v[b]) for k, v in batch.items()}
               for b in range(2)]
    vg = _compile(jax.value_and_grad(_jax_loss), params_sgd, samples[0])
    losses, grads = [], []
    for sample in samples:
        loss, g = vg(params_sgd, sample)
        losses.append(float(loss))
        grads.append(bridge.flatten(np_tree(g)))
    o["sgd.loss"] = float(np.mean(losses))
    o["sgd.grads"] = grads
    o["sgd.grad"] = {k: (grads[0][k] + grads[1][k]) / 2 for k in grads[0]}
    comp = jax.jit(jax.vmap(lambda g, e: compressed_psum_tree(g, "pod", e),
                            axis_name="pod"))
    red1, err1 = comp(pod_grads, jax.tree_util.tree_map(jnp.zeros_like,
                                                        pod_grads))
    red2, _ = comp(pod_grads, err1)
    o["compress"] = {"red1": np_tree(red1), "err1": np_tree(err1),
                     "red2": np_tree(red2)}
    return o


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(11)
    params = randomize_np(af2_tree(CFG), seed=5)
    params_sgd = randomize_np(af2_tree(CFG_SGD), seed=6)
    ev = CFG.evoformer
    msa = rng.standard_normal((CFG.n_seq, CFG.n_res, ev.c_m)).astype(np.float32)
    z = rng.standard_normal((CFG.n_res, CFG.n_res, ev.c_z)).astype(np.float32)
    pod_grads = {"w": rng.standard_normal((4, 64)).astype(np.float32),
                 "b": (1e-3 * rng.standard_normal((4, 8))).astype(np.float32)}
    opm_rows = np.ones((CFG.n_seq,), np.float32)
    opm_rows[-3:] = 0.0
    inp = {"cfg": port_cfg(CFG),
           "cfg_sgd": dataclasses.replace(port_cfg(CFG_SGD), remat="block"),
           "params": params, "params_sgd": params_sgd, "msa": msa, "z": z,
           "pod_grads": pod_grads, "opm_rows": opm_rows,
           "ckpt_dir": str(tmp_path_factory.mktemp("ckpt"))}
    box = {}

    def spawn():
        try:
            box["ranks"] = ranks.spawn(worker.run, 4, inp, device_type="cpu",
                                       timeout_s=TIMEOUT_S, threads=1)
        except BaseException as e:      # re-raised in the test process
            box["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        oracles = _oracles(params, msa, z, params_sgd, pod_grads, opm_rows)
    finally:
        thread.join(TIMEOUT_S + 30)
    assert not thread.is_alive(), "the ranks outlived their deadline"
    if "error" in box:
        raise box["error"]
    return box["ranks"], oracles, params_sgd


def test_dap_naive_opm_matches_jax(world):
    """``dap_outer_product_mean(opm_impl="naive")`` on DAP 2, three padded
    MSA rows masked: the gathered update equals the reference's
    ``outer_product_mean`` (fp32, 2e-4)."""
    got = [world[0][r]["opm.dap_naive"] for r in (2, 3)]
    want = world[1]["opm_naive"]
    for g in got:
        np.testing.assert_allclose(g, want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("name,ranks_of,tol", [
    ("bp", (0, 1), 2e-4), ("dap_sync", (2, 3), 3e-4),
    ("dap_overlap", (2, 3), 3e-4), ("hybrid", (0, 1, 2, 3), 3e-4)])
def test_stack_outputs_match_jax_serial_stack(world, name, ranks_of, tol):
    res, o, _ = world
    for r in ranks_of:
        for got, want in zip(res[r][f"stack.{name}"], o["stack"]):
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("variant", ["af2", "multimer"])
def test_dap_serial_variants_match_the_serial_stack(world, variant):
    """DAP runs the serial variants too (BP and the overlap need
    'parallel'); held to the port's serial stack, itself held to the
    reference by ``tests/test_torch_evoformer.py``."""
    res, _, _ = world
    for r in (2, 3):
        for got, want in zip(res[r][f"stack.dap_{variant}"],
                             res[0][f"stack.serial_{variant}"]):
            np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


def test_bp_forward_equals_the_serial_forward_bitwise(world):
    """The exchange adds zeros to the owner's values: x + 0 == x."""
    res, _, _ = world
    for got, want in zip(res[0]["stack.bp"], res[0]["stack.serial"]):
        assert np.array_equal(got, want)


def test_overlap_resolves_on_and_matches_sync(world):
    res, _, _ = world
    assert res[2]["overlap_resolved"]
    for got, want in zip(res[2]["stack.dap_overlap"], res[2]["stack.dap_sync"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dap_partial_grads_match_jax_per_rank(world):
    """Each DAP rank's gradients BEFORE completion equal the reference's
    per-instance gradients (the same region-exit scaling, the same
    transposes: reduce-scatter for the gathers, the inverse all-to-all)."""
    res, o, _ = world
    gp, gm, gz = o["grads.dap_sync"]
    flat = bridge.flatten(np_tree(gp))
    for r, c in ((2, 0), (3, 1)):
        got = res[r]["grads.dap_sync"]
        _close_grads(got["msa"], np.asarray(gm)[c], f"rank {r} msa")
        _close_grads(got["z"], np.asarray(gz)[c], f"rank {r} z")
        for k, v in flat.items():
            _close_grads(got[f"p.{k}"], v[c][0], f"rank {r} {k}")


MSA_ARM = ("row_attn", "col_attn", "msa_trans", "opm")


def test_bp_partial_grads_split_the_serial_grads(world):
    """Under BP each branch's parameters get their whole gradient on the
    rank that owns the branch and zero on the other; the two ranks' input
    gradients sum to the serial ones (the completing psum's premise)."""
    res, _, _ = world
    serial, g0, g1 = (res[0]["grads.serial"], res[0]["grads.bp"],
                      res[1]["grads.bp"])
    for k, want in serial.items():
        if k.startswith("p."):
            owner, other = ((g0, g1) if k[2:].split(".")[0] in MSA_ARM
                            else (g1, g0))
            np.testing.assert_allclose(owner[k], want, rtol=1e-5, atol=1e-6)
            assert not other[k].any(), k
        else:
            np.testing.assert_allclose(g0[k] + g1[k], want, rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("name,rank", [
    ("serial", 0), ("bp2", 0), ("dap2", 2), ("bp2_dap2", 0), ("bp2_dap2", 3),
    ("data2_bp2", 0), ("data2_bp2", 3)])
def test_sgd_step_matches_jax_oracle(world, name, rank):
    """One SGD step of the whole model (global batch 2, remat on) under
    each plan against ``jax.grad`` of the reference loss with a hand SGD
    update: SGD keeps the gradient's scale visible (Adam would hide a
    factor of the group size)."""
    res, o, params_sgd = world
    got = res[rank][f"sgd.{name}"]
    assert abs(got["loss"] - o["sgd.loss"]) <= 1e-5 * abs(o["sgd.loss"])
    applied = _applied_grads(got, params_sgd)
    assert set(applied) == set(bridge.params_to_state_dict(params_sgd))
    for k, (jk, i, g) in applied.items():
        want = o["sgd.grad"][jk]
        _close_grads(g, want if i is None else want[i], f"{name} {k}")


def _applied_grads(got, params_sgd):
    """{JAX key: (leaf index or None, the gradient the SGD step applied)}."""
    sd = bridge.params_to_state_dict(params_sgd)
    out = {}
    for k, v in got["params"].items():
        head, _, rest = k.partition(".")
        g = (sd[k].numpy() - v) / LR
        if head in bridge.STACKED:
            i, _, rest = rest.partition(".")
            out[k] = (f"{head}.{rest}", int(i), g)
        else:
            out[k] = (k, None, g)
    return out


@pytest.mark.parametrize("rank", [0, 3])
def test_compressed_pod_gradients_stay_within_the_int8_bound(world, rank):
    """pod 2 x BP 2 with ``compress_pod_grads``: each pod's completed
    gradient (one protein each) is quantized against the max over the pods
    of its amax / 127, so the mean the step applies is off by at most half
    that step per element; the error feedback keeps the residual."""
    res, o, params_sgd = world
    got = res[rank]["sgd.pod2_bp2_compressed"]
    assert abs(got["loss"] - o["sgd.loss"]) <= 1e-5 * abs(o["sgd.loss"])
    per = o["sgd.grads"]
    for k, (jk, i, g) in _applied_grads(got, params_sgd).items():
        pods = [p[jk] if i is None else p[jk][i] for p in per]
        scale = max(np.abs(p).max() for p in pods) / 127.0
        want = (pods[0] + pods[1]) / 2
        tol = 0.51 * scale + GRAD_ATOL * max(1.0, float(np.abs(want).max()))
        assert np.abs(g - want).max() <= tol, k
        assert np.abs(got["err"][k]).max() <= 0.51 * scale + 1e-6, k
    assert any(np.abs(e).max() > 0 for e in got["err"].values())


def test_compressed_pod_sum_matches_jax(world):
    res, o, _ = world
    want = o["compress"]
    for r in range(4):
        got = res[r]["compress"]
        for part in ("red1", "red2"):
            for k, v in want[part].items():
                np.testing.assert_allclose(got[part][k], v[r], rtol=1e-6,
                                           atol=1e-6)
        for k, v in want["err1"].items():
            np.testing.assert_allclose(got["err1"][k], v[r], rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("name,want", [
    ("dap_sync", {"all_gather": 6, "all_to_all": 6, "psum": 0}),
    ("dap_overlap", {"all_gather": 5, "all_to_all": 6, "psum": 0}),
    ("bp", {"all_gather": 0, "all_to_all": 0, "psum": 1})])
def test_collectives_per_block(world, name, want):
    """The reference's per-block counts for the fused triangle route
    (``tests/test_parallel_equiv.py``'s ``chunked`` row): the overlap
    schedule issues one all-gather fewer; BP one all-reduce."""
    res, _, _ = world
    for r in ((0, 1) if name == "bp" else (2, 3)):
        got = res[r][f"counts.{name}"]
        assert {k: got[k] for k in want} == want, (r, got)
        assert got["reduce_scatter"] == 0 and got["pmax"] == 0


def test_checkpoint_refuses_another_plan(world):
    res, _, _ = world
    assert res[2]["ckpt"] == {"writer": True, "restored": 0, "refused": True,
                              "adapted": 0}
    assert res[3]["ckpt"]["writer"] is False
    assert res[3]["ckpt"]["refused"] is True


def test_trainrunner_under_hybrid_matches_one_device(world):
    """TrainRunner under BP 2 x DAP 2 (dropout on, fp32): its first loss is
    the one-device runner's, and its evaluation (the inference plan: data 2
    x DAP 2) scores as the one-device runner's does."""
    res, _, _ = world
    want = res[0]["runner.serial"]
    for r in range(4):
        got = res[r]["runner.hybrid"]
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        assert abs(got["lddt"] - want["lddt"]) <= 1e-2


def test_meshes_refactor_and_adapt(world):
    """A (data, model) mesh's model axis splits into branch x dap over the
    same rank order, and a BP x DAP plan adapts to it."""
    res, _, _ = world
    for r in range(4):
        m = res[r]["meshes"]
        assert m["split"] == ({"data": 1, "branch": 2, "dap": 2}, [0, 1, 2, 3])
        assert m["adapted"] == {"data": 1, "branch": 2, "dap": 2}
        assert m["renamed"] == {"data": 1, "branch": 2, "seq": 2}
