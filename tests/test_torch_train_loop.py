"""The port's training loop on the CPU: the optimizer pieces and one update
against ``repro.train.optim`` on the same gradients (to 1e-6), the bridge
of the optimizer state and EMA (bit for bit), the stochastic-recycling
draw against the reference's, ``remat="block"`` against no remat with
dropout on, and the launcher for two steps."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as jaf2
from repro.core.config import af2_tiny as jaf2_tiny
from repro.train import optim as joptim
from repro.train.trainer import TrainRunner as JaxTrainRunner

from repro_torch import bridge
from repro_torch.core import model as taf2
from repro_torch.core.config import af2_tiny, with_kernels
from repro_torch.data.protein import protein_batch
from repro_torch.launch import train as launch_train
from repro_torch.train import optim as toptim
from repro_torch.train.trainer import TrainRunner

from torch_util import np_tree, randomize_np

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


@pytest.mark.parametrize("name,args", [
    ("warmup_constant", (1e-3, 10)),
    ("warmup_cosine", (1e-3, 10, 50)),
    ("af2_lr_schedule", (1e-3, 100, 30)),
])
def test_schedules_match_reference(name, args):
    j, t = getattr(joptim, name)(*args), getattr(toptim, name)(*args)
    for step in (0, 1, 5, 9, 10, 29, 30, 31, 49, 60, 200):
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


@pytest.mark.parametrize("make", [
    lambda m: m.adamw(m.af2_lr_schedule(1e-3, warmup_steps=3),
                      weight_decay=0.01),
    lambda m: m.adamw(1e-2, clip_norm=0.5),
    lambda m: m.sgd(0.05, momentum=0.9),
    lambda m: m.sgd(m.warmup_cosine(0.1, 2, 10), clip_norm=0.3),
])
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
    params = randomize_np(np_tree(jax.jit(lambda k: jaf2.init_params(k, cfg))(
        jax.random.PRNGKey(1))), seed=3)
    opt = joptim.adamw(1e-3)
    state = opt.init(params)
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
    """Each block recomputed under torch.utils.checkpoint draws the same
    dropout masks, so the gradients equal those without remat."""
    base = with_kernels(af2_tiny())
    model = taf2.AlphaFold2(base, seed=2, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
    sample = {k: v[0] for k, v in protein_batch(1, 0, 1, base).items()}
    grads, losses = [], []
    for remat in ("block", "none"):
        cfg = dataclasses.replace(base, remat=remat)
        model.zero_grad(set_to_none=True)
        loss, _ = taf2.loss_fn(model, cfg, sample, n_recycle=2, rng=(1, 0, 0),
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
    # dropout is really on: another rng gives another loss
    other, _ = taf2.loss_fn(model, base, sample, n_recycle=2, rng=(1, 1, 0),
                            deterministic=False, dtype=torch.float32)
    assert other.item() != losses[0]


def test_train_launcher_cpu_two_steps(capsys):
    runner = launch_train.main(["--af2", "tiny", "--steps", "2", "--batch",
                                "1", "--device", "cpu", "--recycle-sample"])
    out = capsys.readouterr().out
    assert "done: 2 steps" in out
    assert len(runner.history["loss"]) == 2
    assert all(np.isfinite(runner.history["loss"]))
    assert runner.history["n_recycle"] == [runner.recycle_draw(s)
                                           for s in range(2)]
    assert runner.state["opt"].step == 2
    ema = runner.state["ema"]
    moved = [k for k, p in runner.model.named_parameters()
             if not torch.equal(p, ema[k])]
    assert moved          # the EMA trails the raw parameters


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
    runner = TrainRunner(cfg, seed=1, device="cpu")
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
