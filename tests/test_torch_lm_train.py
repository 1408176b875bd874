"""The port's LM training (``loss`` of the six families,
``train.trainstep.make_lm_train_step``, ``models.moe``'s capacity routing,
``data.tokens.token_batch`` and ``launch.train --arch``) against the JAX
package, on the CPU.

Weights: the port's own init plus numpy noise, carried into the
reference's layout through ``bridge`` (stacked layers); the batch is
``token_batch``'s (16 tokens a row, 2 rows) plus numpy frames / patches.
Configs: each family's ``get_smoke_config`` (glm4-9b, qwen2-moe-a2.7b,
mamba2-2.7b, zamba2-7b, whisper-medium, internvl2-26b).  The reference's
``jax.value_and_grad(model.loss)`` runs as it is (bf16) and under an fp32
policy in one jit a config (``torch_util.fast_jit``).  The port
runs ``attention_impl="pallas"`` (K6's plain version on CPU tensors, the
plain chunked attention's backward) and, for glm4-9b and whisper,
``remat="layer"`` (``torch.utils.checkpoint`` a layer) where the reference
runs without it: rematerialisation must not change a gradient.

Tolerances: at bf16 the loss within 2e-3 relative and every gradient leaf
within 3e-2 relative L2 (JAX and torch round bf16 at other places), or
twice the reference's own bf16 - fp32 distance where that is larger, as
``tests/test_torch_lm_model.py`` bounds logits; under an fp32 policy on
both sides the loss within 1e-5 and each leaf within 1e-4.  The AdamW
step and the cross entropy are fp32 functions: within 1e-6 relative; the
MoE FFN's outputs and gradients at fp32 within 1e-5 of the largest
value (at least 1).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.tokens import token_batch as jax_token_batch
from repro.models import dense as jdense
from repro.models import get_model as jax_get_model
from repro.models import moe as jmoe
from repro.train import optim as joptim

from repro_torch import bridge
from repro_torch.data.tokens import token_batch
from repro_torch.models import dense as tdense
from repro_torch.models import get_model
from repro_torch.models import moe as tmoe
from repro_torch.nn.layers import Policy
from repro_torch.train import optim as toptim
from repro_torch.train.trainstep import (init_lm_state, lm_value_and_grad,
                                         make_lm_train_step)

from test_torch_lm_model import jax_fp32_policy, port_cfg
from torch_util import fast_jit, lm_tree, max_abs, np_tree, t

ARCHS = ("glm4-9b", "qwen2-moe-a2.7b", "mamba2-2.7b", "zamba2-7b",
         "whisper-medium", "internvl2-26b")
REMAT = ("glm4-9b", "whisper-medium")
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def loaded(arch: str):
    """(config, the reference's params (numpy), the port's model loaded
    with them, a batch (numpy))."""
    cfg = jax_smoke_config(arch, scan_layers=True)
    pcfg = port_cfg(cfg)
    model = get_model(pcfg).init_params(pcfg, seed=0, device="cpu")
    params = lm_tree(model, cfg, 1)
    bridge.load_jax_params(model, params, stacked=bridge.LM_STACKED)
    rng = np.random.default_rng(2)
    batch = token_batch(3, 0, B, S, cfg.vocab)
    if cfg.family in ("audio", "vlm"):
        key = "frames" if cfg.family == "audio" else "patches"
        batch[key] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "vlm":     # the masked mean of the cross entropy
        batch["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return cfg, params, model, batch


def _port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def rel_l2(got, want) -> float:
    g, w = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12))


F32 = Policy(compute_dtype=torch.float32)


def _grads(tree) -> dict:
    """Gradients by key path in the reference's layout (numpy)."""
    if isinstance(tree, dict) and all(isinstance(v, torch.Tensor)
                                      for v in tree.values()):
        tree = bridge.state_dict_to_params(tree, stacked=bridge.LM_STACKED)
    return bridge.flatten(np_tree(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch, monkeypatch):
    """bf16 as the configs run: the loss within 2e-3 relative and each
    leaf within 3e-2 relative L2, or twice the reference's own bf16 - fp32
    distance where that is larger (a MoE's bf16 router moves some tokens to
    other experts on either side; the bias of a key projection has a
    gradient of rounding noise); under an fp32 policy on both sides the
    loss within 1e-5 and each leaf within 1e-4."""
    cfg, params, model, batch = loaded(arch)
    jm = jax_get_model(cfg)
    vg = jax.value_and_grad(lambda p, b: jm.loss(p, cfg, b))

    def both(p, b):
        """Both policies in one jit (one compile: ~30% less than two)."""
        out = vg(p, b)
        with jax_fp32_policy():
            return out, vg(p, b)

    (want_loss, want), (want_loss32, want32) = fast_jit(both)(params,
                                                              batch)
    want, want32 = _grads(want), _grads(want32)
    want_loss, want_loss32 = float(want_loss), float(want_loss32)
    pcfg = port_cfg(cfg)
    if arch in REMAT:
        pcfg = dataclasses.replace(pcfg, remat="layer")
    lm = get_model(pcfg)
    loss, grads = lm_value_and_grad(lm, pcfg, model, _port_batch(batch))
    got = _grads(grads)
    assert loss.dtype == torch.float32
    assert abs(loss.item() - want_loss) <= max(
        2e-3 * abs(want_loss), 2 * abs(want_loss - want_loss32))
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        tol = max(3e-2, 2 * rel_l2(w, want32[key]))
        assert rel_l2(got[key], w) <= tol, (key, rel_l2(got[key], w), tol)
    monkeypatch.setattr(lm, "BF16", F32)
    monkeypatch.setattr(tdense, "BF16", F32)
    loss32, grads32 = lm_value_and_grad(lm, pcfg, model, _port_batch(batch))
    assert abs(loss32.item() - want_loss32) <= 1e-5 * abs(want_loss32)
    got32 = _grads(grads32)
    for key, w in want32.items():
        assert rel_l2(got32[key], w) <= 1e-4, (key, rel_l2(got32[key], w))


def _tree(seed: int, shapes: dict) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def test_adamw_step_matches_jax():
    """Two steps of ``adamw(warmup_cosine(...), clip_norm=1.0)`` (the
    launcher's optimizer) from the same parameters and gradients: the
    parameters and both moments after each, the clip engaged."""
    shapes = {"w": (7, 5), "b": (5,), "e": (3, 4, 2)}
    params, g1, g2 = _tree(0, shapes), _tree(1, shapes), _tree(2, shapes)
    jopt = joptim.adamw(joptim.warmup_cosine(1e-2, 20, 100), clip_norm=1.0)
    topt = toptim.adamw(toptim.warmup_cosine(1e-2, 20, 100), clip_norm=1.0)
    jp, js = params, jopt.init(params)
    tp = {k: t(v) for k, v in params.items()}
    ts = topt.init(tp)
    update = jax.jit(jopt.update)
    for g in (g1, g2):
        assert float(joptim.global_norm(g)) > 1.0
        jp, js = update(g, js, jp)
        tp, ts = topt.update({k: t(v) for k, v in g.items()}, ts, tp)
        for k in shapes:
            for got, want in ((tp[k], jp[k]), (ts.mu[k], js.mu[k]),
                              (ts.nu[k], js.nu[k])):
                want = np.asarray(want)
                assert max_abs(got, want) <= 1e-6 * np.abs(want).max(), k
    assert ts.step == int(js.step) == 2


def _routing_case(cfg, dispatch: str):
    """One MoE layer of ``cfg`` with ``dispatch``, two experts' router
    columns made equal and raised: every token ranks experts 0 and 1
    equally, and most tokens' top two are those two, so their buffers
    overflow ``capacity``.  Returns (cfg, the reference's
    layer params, the port's, x (numpy))."""
    cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
    _, params, model, _ = loaded("qwen2-moe-a2.7b")
    lp = jax.tree_util.tree_map(lambda a: np.array(a[0]),
                                params["layers"])["moe"]
    w = lp["router"]["w"]
    w[:, 1] = w[:, 0]
    w[:, 0] += 0.02
    w[:, 1] += 0.02
    lp["router"]["w"] = w
    tm = tmoe.MoEFFN(port_cfg(cfg), generator=torch.Generator())
    tm.load_state_dict(bridge.params_to_state_dict(lp, stacked=()))
    # features of mean 1: the raised columns add ~2.6 to experts 0 and 1
    x = 1.0 + np.random.default_rng(9).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return cfg, lp, tm, x


@pytest.mark.parametrize("dispatch", ["einsum", "sorted"])
def test_moe_dispatch_drops_and_ties_like_jax(dispatch):
    """``moe_ffn`` (fp32, with the router loss) and its gradients with
    respect to x and the router against the reference under the same
    dispatch, on tokens that overflow capacity and tie their routes; the
    dispatch's kept slots equal the reference's."""
    cfg, lp, tm, x = _routing_case(jax_smoke_config(
        "qwen2-moe-a2.7b", scan_layers=True), dispatch)
    pcfg = port_cfg(cfg)

    def jfn(p, x):
        y, aux = jmoe.moe_ffn(p, cfg, x, return_aux=True)
        return jnp.sum(y * jnp.cos(y)) + aux, (y, aux)

    (_, (want_y, want_aux)), want_g = fast_jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(lp, x)
    xt = t(x).requires_grad_(True)
    y, aux = tmoe.moe_ffn(tm, pcfg, xt, return_aux=True)
    close = lambda got, want: max_abs(got, want) <= 1e-5 * max(
        1.0, float(np.abs(np.asarray(want)).max()))
    assert close(y, want_y)
    assert abs(aux.item() - float(want_aux)) < 1e-6
    (torch.sum(y * torch.cos(y)) + aux).backward()
    assert close(xt.grad, want_g[1])
    assert close(tm.router.w.grad, want_g[0]["router"]["w"])
    assert close(tm.w_up.grad, want_g[0]["w_up"])
    # the case does what it says: ties and drops
    t_tok = B * S
    with torch.no_grad():
        gates, idx, _ = tmoe.router_topk(tmoe.dense_apply(
            tm.router, t(x).reshape(t_tok, -1)), cfg.top_k)
    assert (gates[:, 0] == gates[:, 1]).sum().item() >= t_tok // 2
    cap = tmoe.expert_capacity(pcfg, t_tok)
    e_pad = tmoe.padded_experts(pcfg)
    xf = x.reshape(t_tok, -1)

    def jroutes(xf, w):
        gates, idx, _ = jmoe.router_topk(xf @ w, cfg.top_k)
        disp, _ = jmoe.capacity_dispatch(idx, gates, e_pad, cap)
        _, slot, keep = jmoe.sorted_dispatch(idx, gates, xf, e_pad, cap)
        return idx, disp, slot, keep

    jidx, jdisp, jslot, jkeep = jax.jit(jroutes)(xf, lp["router"]["w"])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    disp, _ = tmoe.capacity_dispatch(idx, gates, e_pad, cap)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))
    assert disp.sum().item() < t_tok * cfg.top_k        # choices dropped
    _, slot, keep = tmoe.sorted_dispatch(idx, gates, t(xf), e_pad, cap)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    """On bf16 logits, with and without a mask (one all-zero row): the
    value and its gradient."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 5), dtype=np.int32)
    mask = (rng.random((3, 5)) < 0.6).astype(np.float32) if masked else None
    if masked:
        mask[1] = 0.0
    lb = jnp.asarray(logits, jnp.bfloat16)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda z: jdense.cross_entropy(z, labels, mask=mask)))(lb)
    lt = t(np.asarray(lb, np.float32), torch.bfloat16).requires_grad_(True)
    got = tdense.cross_entropy(lt, torch.as_tensor(labels),
                               mask=None if mask is None else t(mask))
    got.backward()
    assert got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    assert lt.grad.dtype == torch.bfloat16
    assert max_abs(lt.grad, want_g) <= 2.0 ** -8 * np.abs(
        np.asarray(want_g, np.float32)).max()


@pytest.mark.parametrize("args", [(0, 0, 2, 16, 128, 0, 1),
                                  (7, 3, 4, 33, 51865, 1, 2),
                                  (123, 1 << 12, 8, 5, 92553, 3, 4)])
def test_token_batch_is_the_references(args):
    seed, step, batch, seq, vocab, host, hosts = args
    want = jax_token_batch(seed, step, batch, seq, vocab, host_id=host,
                           n_hosts=hosts)
    got = token_batch(seed, step, batch, seq, vocab, host_id=host,
                      n_hosts=hosts)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_microbatch_accumulation_matches_one_batch(monkeypatch):
    """``make_lm_train_step(microbatch=2)`` on glm4-9b's smoke config under
    an fp32 policy: the loss of the whole batch in one pass within 1e-6,
    and, after one plain-SGD step at lr 1 (a parameter moves by minus its
    gradient), every parameter within 1e-5 of the largest move."""
    cfg, params, _, batch = loaded("glm4-9b")
    pcfg = port_cfg(cfg)
    monkeypatch.setattr(tdense, "BF16", F32)
    lm = get_model(pcfg)
    runs = []
    for micro in (None, 2):
        model = lm.init_params(pcfg, device="cpu")
        bridge.load_jax_params(model, params, stacked=bridge.LM_STACKED)
        opt = toptim.sgd(1.0)
        step = make_lm_train_step(lm, pcfg, opt, microbatch=micro)
        state, metrics = step(init_lm_state(model, opt), _port_batch(batch))
        assert state["opt"].step == 1
        runs.append((metrics["loss"].item(),
                     {k: p.detach().clone()
                      for k, p in model.named_parameters()}))
    (l1, p1), (l2, p2) = runs
    assert abs(l1 - l2) <= 1e-6 * abs(l1)
    start = bridge.params_to_state_dict(params, stacked=bridge.LM_STACKED)
    moved = max((p1[k] - start[k]).abs().max().item() for k in p1)
    for k in p1:
        assert (p1[k] - p2[k]).abs().max().item() <= 1e-5 * moved, k


def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    """``launch.train --arch glm4-9b --smoke``: four steps in one run; two
    steps with a checkpoint every step, then ``--resume`` to four: the
    resumed run's losses are the uninterrupted run's, bit for bit."""
    from repro_torch.launch import train
    base = ["--arch", "glm4-9b", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "16"]
    whole = train.main(base + ["--steps", "4"])
    out = capsys.readouterr().out
    assert sorted(whole) == [0, 1, 2, 3]
    assert "step     3  loss" in out and out.rstrip().endswith("done")
    ck = base + ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "1"]
    first = train.main(ck + ["--steps", "2"])
    assert first == {k: whole[k] for k in (0, 1)}
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_0000000001", "step_0000000002"]
    resumed = train.main(ck + ["--steps", "4", "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed == {k: whole[k] for k in (2, 3)}
    with pytest.raises(SystemExit, match="does not split"):
        train.main(base + ["--devices", "3"])
