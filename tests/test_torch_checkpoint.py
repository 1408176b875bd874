"""The port's checkpoints, step watchdog, resumed training and
``remat="dots"`` (``repro_torch.train.checkpoint``, ``TrainRunner``,
``core.model``), on the CPU, against the JAX package where it has a
counterpart.

No tolerance: a checkpoint is bytes, so the format is checked both ways bit
for bit (the reference writes an af2_tiny train state that the port
restores, the port writes one the reference restores, with the names in the
reference's order); a resumed run replays the uninterrupted run's steps on
the same batches, dropout keys and draws, so its losses, parameters,
moments and EMA are equal bit for bit; ``remat="dots"`` keeps the outputs of
products that ``remat="none"`` computes once, and recomputes the rest with
the same operations, so its loss and gradients are equal bit for bit too.
Its ``cuda`` counterpart, a restore into a captured training graph, is in
``tests/test_torch_graphs.py``, which imports no JAX and so runs on the
card.
"""
import dataclasses
import signal

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.config import af2_tiny as jaf2_tiny
from repro.train import checkpoint as jck
from repro.train import optim as joptim

from repro_torch import bridge
from repro_torch.core import evoformer as tevo
from repro_torch.core import model as taf2
from repro_torch.core.config import af2_tiny, with_kernels
from repro_torch.data.ingest import FastaSource, demo_fasta
from repro_torch.data.protein import protein_batch
from repro_torch.launch import train as launch_train
from repro_torch.train import checkpoint as ck
from repro_torch.train import optim as toptim
from repro_torch.train.trainer import TrainRunner
from repro_torch.train.trainstep import init_state

from torch_util import af2_tree, np_tree, randomize_np

CFG = with_kernels(af2_tiny())


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def _port_state(seed=0):
    """An af2_tiny train state of the port (AdamW moments, EMA) with every
    tensor drawn at random, optimizer step 5."""
    model = taf2.AlphaFold2(CFG, seed=seed, device="cpu")
    opt = toptim.adamw(1e-3)
    state = init_state(model, opt, toptim.ema())
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for tensors in (dict(model.named_parameters()), state["opt"].mu,
                        state["opt"].nu, state["ema"]):
            for t in tensors.values():
                t.copy_(torch.randn(t.shape, generator=g))
    state["opt"] = state["opt"]._replace(step=5)
    return state


def _port_tensors(state) -> dict:
    """{(part, key): tensor} over the parameters, moments and EMA."""
    out = {}
    for part, tensors in (("params", dict(state["params"].named_parameters())),
                          ("mu", state["opt"].mu), ("nu", state["opt"].nu),
                          ("ema", state["ema"])):
        out.update({(part, k): t for k, t in tensors.items()})
    return out


def _reference_state(seed=3) -> dict:
    """The reference's train state tree for af2_tiny (numpy leaves, every
    leaf random, optimizer step 7)."""
    params = randomize_np(af2_tree(jaf2_tiny(), seed=1), seed=seed)
    mu = randomize_np(params, seed=seed + 1, scale=1.0)
    nu = randomize_np(params, seed=seed + 2, scale=1.0)
    return {"params": params,
            "opt": joptim.OptState(np.int32(7), mu, nu),
            "ema": randomize_np(params, seed=seed + 3)}


# ---------------------------------------------------------------------------
# the format, both ways
# ---------------------------------------------------------------------------

def test_names_and_order_equal_the_references():
    ref = _reference_state()
    # the reference optimizer's own state layout, traced once, not run
    opt = jax.eval_shape(joptim.adamw(1e-3).init, ref["params"])
    want, _, _ = jck._flatten_with_names({**ref, "opt": opt})
    got, leaves = ck._flatten_with_names(ck.train_state_tree(_port_state()))
    assert got == want
    assert got[:1] == ["['ema']['embedder']['extra_msa_proj']['b']"]
    assert "['opt'].step" in got and "['opt'].mu['evoformer']['row_attn']" \
        "['q']['w']" in got
    assert "['params']['evoformer']['row_attn']['q']['w']" in got
    stacked = leaves[got.index("['params']['evoformer']['row_attn']['q']['w']")]
    assert isinstance(stacked, ck.Stacked) and \
        stacked.shape[0] == CFG.n_evoformer


def test_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    ref = _reference_state()
    jck.save_checkpoint(tmp_path, 7, ref)
    state = _port_state()
    ptrs = {k: t.data_ptr() for k, t in _port_tensors(state).items()}
    tree, step = ck.restore_checkpoint(tmp_path, ck.train_state_tree(state))
    assert step == 7 and int(tree["opt"].step) == 7
    want = {"params": bridge.params_to_state_dict(ref["params"]),
            "mu": bridge.params_to_state_dict(ref["opt"].mu),
            "nu": bridge.params_to_state_dict(ref["opt"].nu),
            "ema": bridge.params_to_state_dict(ref["ema"])}
    for (part, k), t in _port_tensors(state).items():
        assert _bits(t) == _bits(want[part][k]), (part, k)
        assert t.data_ptr() == ptrs[(part, k)], (part, k)   # copied into


def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    state = _port_state(seed=4)
    ck.save_checkpoint(tmp_path, 5, ck.train_state_tree(state))
    like = _reference_state()
    restored, step = jck.restore_checkpoint(tmp_path, like)
    assert step == 5 and int(restored["opt"].step) == 5
    assert restored["opt"].step.dtype == jnp.int32
    want = {"params": bridge.state_dict_to_params(
                dict(state["params"].named_parameters())),
            "opt": bridge.opt_state_to_jax(state["opt"]),
            "ema": bridge.state_dict_to_params(state["ema"])}
    got = {"params": restored["params"], "ema": restored["ema"],
           "opt": {"mu": restored["opt"].mu, "nu": restored["opt"].nu}}
    want["opt"].pop("step")
    fg, fw = bridge.flatten(np_tree(got)), bridge.flatten(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        assert fg[k].dtype == fw[k].dtype and _bits(fg[k]) == _bits(fw[k]), k


def test_bf16_leaf_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    b = rng.standard_normal((4,)).astype(ml_dtypes.bfloat16)
    f = rng.standard_normal((2,)).astype(np.float32)
    jck.save_checkpoint(tmp_path / "ref", 1,
                        {"w": jnp.asarray(w), "b": jnp.asarray(b), "f": f})
    port = {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
            "b": torch.zeros((4,), dtype=torch.bfloat16),
            "f": torch.zeros((2,))}
    ck.restore_checkpoint(tmp_path / "ref", port)
    for k, want in (("w", w), ("b", b), ("f", f)):
        assert _bits(port[k]) == want.tobytes(), k
    ck.save_checkpoint(tmp_path / "port", 2, port)
    back, _ = jck.restore_checkpoint(
        tmp_path / "port", {"w": jnp.zeros((3, 5), jnp.bfloat16),
                            "b": jnp.zeros((4,), jnp.bfloat16),
                            "f": jnp.zeros((2,), jnp.float32)})
    for k, want in (("w", w), ("b", b), ("f", f)):
        got = np.asarray(back[k])
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), k


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

def _small_tree(v=0.0):
    return {"params": {"w": torch.full((2, 3), v),
                       "b": torch.ones((3,), dtype=torch.bfloat16)},
            "step_stuff": (np.asarray(3, np.int32), np.asarray(2.5))}


def test_latest_keep_n_async_wait_and_no_partial_dirs(tmp_path):
    assert ck.latest_step(tmp_path) is None
    mgr = ck.CheckpointManager(tmp_path, keep=2)
    tree = _small_tree()
    for s in (1, 5, 9):
        tree["params"]["w"].fill_(float(s))
        mgr.save(s, tree)
        tree["params"]["w"].fill_(-1.0)      # save snapshot it already
    mgr.wait()
    assert ck.latest_step(tmp_path) == 9
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000005", "step_0000000009"]       # keep 2, no tmp.*
    assert ck.checkpoint_meta(tmp_path) == {}
    assert ck.checkpoint_bytes(tmp_path) > 0
    assert len(mgr.stats["snapshot_s"]) == len(mgr.stats["save_s"]) == 3
    out, step = mgr.restore(_small_tree(), step=5)
    assert step == 5 and bool((out["params"]["w"] == 5.0).all())
    assert out["step_stuff"][0] == 3 and isinstance(out["step_stuff"], tuple)
    _, step = mgr.restore_latest(_small_tree())
    assert step == 9 and len(mgr.stats["restore_s"]) == 2


def test_structure_shape_and_dtype_mismatches_raise(tmp_path):
    ck.save_checkpoint(tmp_path, 0, _small_tree())
    with pytest.raises(ValueError, match="structure mismatch"):
        ck.restore_checkpoint(tmp_path, {"other": torch.zeros(3)})
    bad = _small_tree()
    bad["params"]["w"] = torch.zeros((3, 2))
    with pytest.raises(ValueError, match="w"):
        ck.restore_checkpoint(tmp_path, bad)
    bad = _small_tree()
    bad["params"]["b"] = torch.ones((3,))
    with pytest.raises(ValueError, match="b"):
        ck.restore_checkpoint(tmp_path, bad)
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(tmp_path / "empty", _small_tree())


def test_plan_meta_mismatch_raises_unless_adapt(tmp_path):
    ck.save_checkpoint(tmp_path, 0, _small_tree(),
                       meta={"plan": {"bp": 2, "dap": 1}, "mesh": {"n": 4}})
    other = {"plan": {"bp": 1, "dap": 1}, "mesh": {"n": 4}}
    with pytest.raises(ck.PlanMismatchError, match="bp"):
        ck.restore_checkpoint(tmp_path, _small_tree(), expect_meta=other)
    ck.restore_checkpoint(tmp_path, _small_tree(), expect_meta=other,
                          adapt_plan=True)
    ck.restore_checkpoint(tmp_path, _small_tree(), expect_meta={})
    # the same verdicts as the reference's, field for field
    for stored, current, adapt in (
            ({"plan": {"bp": 2}}, {"plan": {"bp": 1}}, False),
            ({"plan": {"bp": 2}}, {"plan": {"bp": 1}}, True),
            ({"plan": {"bp": 2}, "mesh": {"n": 1}},
             {"plan": {"bp": 2}, "mesh": {"n": 8}}, False),
            ({}, {"plan": {"bp": 1}}, False), (None, None, False)):
        verdicts = []
        for fn, err in ((ck.check_plan_meta, ck.PlanMismatchError),
                        (jck.check_plan_meta, jck.PlanMismatchError)):
            try:
                fn(stored, current, adapt=adapt)
                verdicts.append(None)
            except err as e:
                verdicts.append(str(e))
        assert verdicts[0] == verdicts[1]


def test_step_watchdog_matches_reference(monkeypatch):
    walls = [1.0, 1.1, 0.9, 5.0, 1.0, 2.5, 1.2, 0.1, 3.0]
    clock = {"t": 0.0}
    monkeypatch.setattr(ck.time, "perf_counter", lambda: clock["t"])
    monkeypatch.setattr(jck.time, "perf_counter", lambda: clock["t"])
    runs = []
    for cls in (ck.StepWatchdog, jck.StepWatchdog):
        clock["t"] = 0.0
        calls = []
        wd = cls(threshold=2.0, decay=0.9,
                 on_straggler=lambda s, dt, ema: calls.append((s, dt, ema)))
        flags, emas = [], []
        for step, dt in enumerate(walls):
            wd.start_step()
            clock["t"] += dt
            flags.append(wd.end_step(step))
            emas.append(wd.ema)
        runs.append((flags, emas, wd.flagged, calls))
    assert runs[0] == runs[1]
    assert runs[0][0].count(True) >= 2


# ---------------------------------------------------------------------------
# resumed training
# ---------------------------------------------------------------------------

def _fasta_runner(tmp_path, seed_model=0, **kw):
    source = FastaSource(demo_fasta(CFG, n_records=6, seed=2), CFG)
    return TrainRunner(CFG, seed=2, max_recycle=2, device="cpu",
                       model=taf2.AlphaFold2(CFG, seed=seed_model,
                                             device="cpu"),
                       data_source=source, bucket_by_length=True,
                       ckpt_dir=str(tmp_path), ckpt_every=2, keep=2, **kw)


def test_resumed_cpu_run_equals_the_uninterrupted_run(tmp_path):
    """FASTA records, length-bucketed (padded residues in every batch),
    stochastic recycling and dropout on: 4 steps, checkpoints at 2 and 4,
    against a runner from another model seed that restores step 2 and
    trains to 4."""
    a = _fasta_runner(tmp_path, data_workers=2)
    a.run(4)
    assert ck.latest_step(tmp_path) == 4
    assert a.history["data"][-1]["mean_fill"] < 1.0
    assert a.watchdog.ema is not None and len(a.history["step_s"]) == 4
    b = _fasta_runner(tmp_path, seed_model=9, data_workers=0)
    ptrs = {k: t.data_ptr() for k, t in _port_tensors(b.state).items()}
    assert b.restore(step=2) == 2 and b.step == 2
    assert b.state["opt"].step == 2
    assert {k: t.data_ptr() for k, t in _port_tensors(b.state).items()} == ptrs
    b.run(4)
    assert b.history["loss"] == a.history["loss"][2:]
    assert b.history["n_recycle"] == a.history["n_recycle"][2:]
    assert b.state["opt"].step == a.state["opt"].step == 4
    ta, tb = _port_tensors(a.state), _port_tensors(b.state)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert _bits(ta[k]) == _bits(tb[k]), k
    # restore without a checkpoint directory
    with pytest.raises(ValueError, match="ckpt_dir"):
        TrainRunner(CFG, device="cpu").restore()


def test_remat_dots_equals_no_remat_with_dropout():
    """Selective checkpointing keeps the Evoformer blocks' 2-D product
    outputs and recomputes the rest: loss and every gradient bit for bit
    those without remat, dropout on."""
    base = CFG
    model = taf2.AlphaFold2(base, seed=2, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
    sample = {k: v[0] for k, v in protein_batch(1, 0, 1, base).items()}
    key = tevo.Key(tevo.dropout_key((1, 0), "cpu").lanes, (0,))
    grads, losses = [], []
    for remat in ("dots", "none"):
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
        assert torch.equal(grads[0][k], grads[1][k]), k
    with pytest.raises(ValueError, match="dots"):
        taf2.remat_blocks(dataclasses.replace(base, remat="offload"))


def test_launcher_trains_from_fasta_and_resumes(tmp_path, capsys):
    before = signal.getsignal(signal.SIGTERM)
    flags = ["--af2", "tiny", "--batch", "1", "--device", "cpu",
             "--data-source", "fasta", "--bucket-by-length", "--ckpt-dir",
             str(tmp_path), "--ckpt-every", "1", "--data-workers", "2"]
    try:
        first = launch_train.main(flags + ["--steps", "3"])
        out = capsys.readouterr().out
        assert "data: fasta source, 8 records" in out and "done: 3 steps" in out
        assert "stragglers flagged" in out and "data (2 workers)" in out
        assert ck.latest_step(tmp_path) == 3
        second = launch_train.main(flags + ["--steps", "4", "--resume"])
        out = capsys.readouterr().out
        assert "resumed from step 3" in out and "done: 4 steps" in out
    finally:
        signal.signal(signal.SIGTERM, before)
    assert second.step == 4 and len(second.history["loss"]) == 1
    assert ck.latest_step(tmp_path) == 4
    assert np.isfinite(first.history["loss"] + second.history["loss"]).all()
    with pytest.raises(SystemExit, match="needs --data-source fasta"):
        launch_train.main(["--af2", "tiny", "--device", "cpu",
                           "--bucket-by-length"])

