"""The port's training loop on the CPU: the optimizer pieces and one update
against ``repro.train.optim`` on the same gradients (to 1e-6), their
device-scalar path against the host path (bit for bit), the bridge of the
optimizer state and EMA (bit for bit), the stochastic-recycling draw
against the reference's, ``remat="block"`` against no remat with dropout
on, the step body's capture safety, and the launcher for two steps with
an evaluation."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import af2_tiny as jaf2_tiny
from repro.train import optim as joptim
from repro.train.trainer import TrainRunner as JaxTrainRunner

from repro_torch import bridge
from repro_torch.core import evoformer as tevo
from repro_torch.core import model as taf2
from repro_torch.core.config import af2_tiny, with_kernels
from repro_torch.data.protein import protein_batch
from repro_torch.launch import train as launch_train
from repro_torch.train import optim as toptim
from repro_torch.train.trainer import TrainRunner

from torch_util import af2_tree, np_tree, randomize_np

TOL = 1e-6


def _tree(rng, scale=1.0):
    shapes = {"a": {"w": (5, 3), "b": (3,)}, "c": (7,)}
    return jax.tree_util.tree_map(
        lambda s: (scale * rng.standard_normal(s)).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))


def _flat(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            bridge.flatten(tree).items()}


def _close(got: dict, want_tree, tol=TOL):
    want = bridge.flatten(jax.tree_util.tree_map(np.asarray, want_tree))
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, atol=tol, rtol=tol,
                                   err_msg=k)


SCHEDULES = [("warmup_constant", (1e-3, 10)),
             ("warmup_cosine", (1e-3, 10, 50)),
             ("af2_lr_schedule", (1e-3, 100, 30))]


@pytest.mark.parametrize("name,args", SCHEDULES)
def test_schedules_match_reference(name, args):
    j, t = getattr(joptim, name)(*args), getattr(toptim, name)(*args)
    for step in (0, 1, 5, 9, 10, 29, 30, 31, 49, 60, 200):
        assert abs(t(step) - float(j(jnp.asarray(step, jnp.int32)))) <= TOL * 1e-3


# steps around the warm-up's end and the AF2 decay at 50k
DEVICE_STEPS = (1, 2, 99, 100, 101, 49999, 50000, 50001)


@pytest.mark.parametrize("name,args", SCHEDULES + [
    ("af2_lr_schedule", (1e-3, 100)), ("warmup_cosine", (1e-3, 100, 60000))])
def test_device_schedules_equal_the_host_path_bit_for_bit(name, args):
    """``Schedule.on_device`` (a captured step's learning rate, from a 0-d
    fp32 step tensor) gives the host path's fp32 value exactly, and both
    still match the reference."""
    j, t = getattr(joptim, name)(*args), getattr(toptim, name)(*args)
    for step in DEVICE_STEPS:
        dev = t.on_device(torch.tensor(float(step)))
        assert dev.dtype == torch.float32 and dev.dim() == 0
        assert dev.item() == t(step), step
        assert abs(t(step) - float(j(jnp.asarray(step, jnp.int32)))) <= TOL * 1e-3


def test_clipping_and_norm_match_reference():
    rng = np.random.default_rng(0)
    g = _tree(rng)
    assert abs(float(toptim.global_norm(_flat(g)))
               - float(joptim.global_norm(g))) <= TOL
    for max_norm in (0.1, 1e3):
        got, n = toptim.clip_by_global_norm(_flat(g), max_norm)
        want, jn = joptim.clip_by_global_norm(g, max_norm)
        _close(got, want)
        assert abs(float(n) - float(jn)) <= TOL


OPTIMIZERS = [
    lambda m: m.adamw(m.af2_lr_schedule(1e-3, warmup_steps=3),
                      weight_decay=0.01),
    lambda m: m.adamw(1e-2, clip_norm=0.5),
    lambda m: m.sgd(0.05, momentum=0.9),
    lambda m: m.sgd(m.warmup_cosine(0.1, 2, 10), clip_norm=0.3),
]


@pytest.mark.parametrize("make", OPTIMIZERS)
def test_optimizer_updates_match_reference(make):
    rng = np.random.default_rng(1)
    params = _tree(rng)
    jopt, topt = make(joptim), make(toptim)
    jp, js = params, jopt.init(params)
    tp = _flat(params)
    ts = topt.init(tp)
    for _ in range(3):
        g = _tree(rng, scale=0.3)
        jp, js = jopt.update(g, js, jp)
        tp, ts = topt.update(_flat(g), ts, tp)
    _close(tp, jp)
    _close(ts.mu, js.mu)
    _close(ts.nu, js.nu)
    assert ts.step == int(js.step) == 3


@pytest.mark.parametrize("make", OPTIMIZERS + [
    lambda m: m.adamw(m.af2_lr_schedule(1e-3, warmup_steps=100),
                      per_sample_clip=0.1)])
def test_device_update_equals_host_update_bit_for_bit(make):
    """``opt.apply`` with the step as a 0-d fp32 tensor (learning rate and
    bias corrections computed from it, as in a captured step) writes the
    same bits as the host ``update``, and both match the reference, at
    steps around the warm-up's end and the AF2 decay."""
    rng = np.random.default_rng(3)
    jopt, topt = make(joptim), make(toptim)
    for step in DEVICE_STEPS:
        params, g = _tree(rng), _tree(rng, scale=0.3)
        mu, nu = _tree(rng, scale=0.1), _tree(rng, scale=0.01)
        nu = jax.tree_util.tree_map(np.abs, nu)
        host = (_flat(params), toptim.OptState(step - 1, _flat(mu), _flat(nu)))
        dev = (_flat(params), toptim.OptState(step - 1, _flat(mu), _flat(nu)))
        _, state = topt.update(_flat(g), host[1], host[0])
        assert state.step == step
        topt.apply(_flat(g), dev[1], dev[0], torch.tensor(float(step)))
        for a, b in ((host[0], dev[0]), (host[1].mu, dev[1].mu),
                     (host[1].nu, dev[1].nu)):
            for k in a:
                assert torch.equal(a[k], b[k]), (step, k)
        jp, js = jopt.update(g, joptim.OptState(jnp.int32(step - 1), mu, nu),
                             params)
        _close(dev[0], jp)
        _close(dev[1].mu, js.mu)
        _close(dev[1].nu, js.nu)


def test_ema_matches_reference():
    rng = np.random.default_rng(2)
    params = _tree(rng)
    je, te = joptim.ema(0.9), toptim.ema(0.9)
    js, ts = je.init(params), te.init(_flat(params))
    for _ in range(3):
        params = _tree(rng)
        js = je.update(js, params)
        ts = te.update(ts, _flat(params))
    _close(ts, js)
    with pytest.raises(ValueError):
        toptim.ema(1.0)


def test_bridge_round_trips_opt_state_and_ema_bit_for_bit():
    cfg = jaf2_tiny()
    params = randomize_np(af2_tree(cfg, seed=1), seed=3)
    opt = joptim.adamw(1e-3)
    # the reference optimizer's state layout, traced once: its moments are
    # zeros of the params' shapes (running opt.init op by op compiles each)
    state = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   jax.eval_shape(opt.init, params))
    mu = randomize_np(np_tree(state.mu), seed=4, scale=1.0)
    nu = randomize_np(np_tree(state.nu), seed=5, scale=1.0)
    port = bridge.opt_state_to_port(np.int32(7), mu, nu)
    model = taf2.AlphaFold2(with_kernels(af2_tiny()), device="cpu")
    keys = [k for k, _ in model.named_parameters()]
    assert sorted(port.mu) == sorted(keys) and port.step == 7
    back = bridge.opt_state_to_jax(port)
    assert back["step"] == 7 and back["step"].dtype == np.int32
    rebuilt = joptim.OptState(**back)
    for a, b in ((mu, rebuilt.mu), (nu, rebuilt.nu)):
        fa, fb = bridge.flatten(a), bridge.flatten(b)
        assert sorted(fa) == sorted(fb)
        for k in fa:
            assert fa[k].dtype == fb[k].dtype
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    ema = toptim.ema().init(bridge.params_to_state_dict(params))
    fe, fp = bridge.flatten(bridge.state_dict_to_params(ema)), bridge.flatten(params)
    for k in fp:
        np.testing.assert_array_equal(fe[k], fp[k], err_msg=k)


def test_recycle_draw_equals_reference():
    for seed, max_recycle in ((0, 4), (3, 3)):
        stub = type("R", (), dict(seed=seed, recycle_sample=True,
                                  max_recycle=max_recycle, n_recycle=1))()
        want = [JaxTrainRunner.recycle_draw(stub, s) for s in range(20)]
        runner = TrainRunner(af2_tiny(), seed=seed, max_recycle=max_recycle,
                             device="cpu")
        assert [runner.recycle_draw(s) for s in range(20)] == want
        assert len(set(want)) > 1


def test_remat_block_equals_no_remat_with_dropout():
    """Each block recomputed under torch.utils.checkpoint (which stashes no
    RNG state) draws the same dropout masks, so the gradients equal those
    without remat."""
    base = with_kernels(af2_tiny())
    model = taf2.AlphaFold2(base, seed=2, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
    sample = {k: v[0] for k, v in protein_batch(1, 0, 1, base).items()}
    # the training step's key: device lanes of (seed, step), protein 0
    key = tevo.Key(tevo.dropout_key((1, 0), "cpu").lanes, (0,))
    grads, losses = [], []
    for remat in ("block", "none"):
        cfg = dataclasses.replace(base, remat=remat)
        model.zero_grad(set_to_none=True)
        loss, _ = taf2.loss_fn(model, cfg, sample, n_recycle=2, rng=key,
                               deterministic=False, dtype=torch.float32)
        loss.backward()
        losses.append(loss.item())
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
    assert losses[0] == losses[1]
    assert sorted(grads[0]) == sorted(grads[1])
    for k in grads[0]:
        torch.testing.assert_close(grads[0][k], grads[1][k], atol=1e-6,
                                   rtol=1e-6, msg=k)
    # dropout is really on: another step's key gives another loss
    other, _ = taf2.loss_fn(model, base, sample, n_recycle=2,
                            rng=tevo.fold_in(tevo.dropout_key((1, 1), "cpu"), 0),
                            deterministic=False, dtype=torch.float32)
    assert other.item() != losses[0]


def test_train_launcher_cpu_two_steps(capsys):
    """Two steps (draws 1 and 2 at seed 1) and an evaluation at step 2; a
    step is built per distinct draw, the eval engine once however often
    ``evaluate`` runs."""
    runner = launch_train.main(["--af2", "tiny", "--steps", "2", "--batch",
                                "1", "--device", "cpu", "--recycle-sample",
                                "--max-recycle", "2", "--seed", "1",
                                "--eval-every", "2"])
    out = capsys.readouterr().out
    assert "done: 2 steps" in out and "eval @ 2: lDDT-Cα" in out
    assert len(runner.history["loss"]) == 2
    assert all(np.isfinite(runner.history["loss"]))
    assert runner.history["n_recycle"] == [runner.recycle_draw(s)
                                           for s in range(2)] == [1, 2]
    assert runner.state["opt"].step == 2
    assert not runner.graphs
    assert runner.train_compiles == 2 and runner.eval_compiles == 1
    (row,) = runner.history["eval"]
    assert row["step"] == 2 and 0.0 <= row["lddt_ca"] <= 100.0
    again = runner.evaluate()
    assert again["lddt_ca"] == row["lddt_ca"]
    assert runner.eval_compiles == 1 and runner.compile_misses == 3
    assert again["coords"].shape == (2, 16, 3)
    ema = runner.state["ema"]
    moved = [k for k, p in runner.model.named_parameters()
             if not torch.equal(p, ema[k])]
    assert moved          # the EMA trails the raw parameters


def test_step_body_reads_nothing_back_and_copies_nothing_in(monkeypatch):
    """Capture-safety guard: after one eager call (which fills the per-device
    constants, as a captured step's first call does), the step body with
    dropout on runs with every host read of a tensor and every host-to-
    device tensor construction raising, so a capture would neither reject
    nor freeze it."""
    from repro_torch.train import trainstep
    cfg = with_kernels(af2_tiny())
    opt = toptim.adamw(toptim.af2_lr_schedule(1e-3, warmup_steps=100),
                       per_sample_clip=0.1)
    ema = toptim.ema()
    state = trainstep.init_state(taf2.AlphaFold2(cfg, seed=0, device="cpu"),
                                 opt, ema)
    body = trainstep.make_step_body(cfg, opt, deterministic=False, ema=ema)
    args = trainstep.step_inputs(protein_batch(0, 0, 1, cfg), (0, 0), 1,
                                 "cpu")
    body(state, *args, 1)

    def host_read(*a, **kw):
        raise AssertionError("a host read or copy inside the step body")

    for name in ("item", "__float__", "__int__", "__bool__", "tolist",
                 "numpy"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    monkeypatch.setattr(torch, "tensor", host_read)
    monkeypatch.setattr(torch, "from_numpy", host_read)
    out = body(state, *args, 2)
    monkeypatch.undo()
    assert len(out) == len(trainstep.METRICS)
    assert all(v.dim() == 0 and bool(torch.isfinite(v)) for v in out)


def test_training_step_launch_counts_follow_the_draw(monkeypatch):
    """Every wrapper replaced by its plain version raising the same launch
    counter, and ops routed to the wrappers as for CUDA tensors: one step
    of one protein launches K1 and K3 in each of its n_recycle forwards and
    once more in the grad cycle's remat recompute, K2 and K4 once per grad-
    cycle forward launch, K5 twice (one per operand side)."""
    from repro_torch.kernels import evo_attention as ka
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import triangle as kt

    def counted(mod, attr, fn):
        def wrapper(*args, **kw):
            setattr(mod, attr, getattr(mod, attr) + 1)
            return fn(*args, **kw)
        return wrapper

    def tri_fwd(*args, k_mask=None, return_s=False):
        return ref.triangle_mult_ref(*args, k_mask=k_mask, return_s=return_s)
    for mod, name, attr, fn in (
            (ka, "evo_attention_fwd", "launches", ref.evo_attention_ref),
            (ka, "evo_attention_bwd", "bwd_launches", ref.evo_attention_bwd_ref),
            (kt, "triangle_mult_fwd", "launches", tri_fwd),
            (kt, "triangle_mult_bwd_epilogue", "epi_launches",
             ref.triangle_mult_bwd_epilogue_ref),
            (kt, "triangle_mult_bwd_dx", "dx_launches",
             ref.triangle_mult_bwd_dx_ref)):
        monkeypatch.setattr(mod, name, counted(mod, attr, fn))
    monkeypatch.setattr(ops, "_on_cuda", lambda *tensors: True)
    cfg = af2_tiny()
    runner = TrainRunner(cfg, seed=1, max_recycle=2, device="cpu")
    ops.reset_launch_counts()
    runner.run(2)
    k1 = 4 * cfg.n_evoformer + 3 * cfg.n_extra_msa_blocks
    k3 = 2 * (cfg.n_evoformer + cfg.n_extra_msa_blocks)
    n = runner.history["n_recycle"]
    assert ops.launch_counts() == {
        "evo_attention_fwd": sum(k1 * (nr + 1) for nr in n),
        "evo_attention_bwd": 2 * k1,
        "triangle_mult_fwd": sum(k3 * (nr + 1) for nr in n),
        "triangle_mult_bwd_epilogue": 2 * k3,
        "triangle_mult_bwd_dx": 4 * k3,
        "flash_attention_fwd": 0}
    ops.reset_launch_counts()
