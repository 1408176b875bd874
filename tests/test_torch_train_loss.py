"""The port's training loss and its gradients against the JAX package, at
af2_tiny widths, fp32, deterministic (no dropout: JAX and torch random
streams differ), on synthetic proteins and on a record-path batch whose
proteins are all shorter than the bucket (``res_mask`` 0 on the padding).

One module-scoped ``jax.jit(jax.value_and_grad(..., has_aux=True))`` with a
traced ``n_recycle`` serves every case (one compile), and each (protein,
``n_recycle``) it is asked for is computed once.  JAX runs its ``chunked``
impls (its Pallas kernels do not run on the installed JAX); the port runs
the kernel impls, which on CPU tensors are the kernels' plain versions, with
the backward through the plain K2/K4/K5 and ``remat="block"`` as
``torch.utils.checkpoint``.  Same randomized parameters (carried by
``repro_torch.bridge``) and the same numpy proteins on both sides.

Tolerances (fp32): loss and each of its terms 1e-5 relative; every
gradient leaf
|port - jax| <= 1e-4 * max(1, max|jax leaf|) + 1e-3 * |jax| — the two
packages sum in different orders through two recycles of the trunk, the
structure module and four losses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heads as jheads
from repro.core import model as jaf2
from repro.core.config import af2_tiny
from repro.train import optim as joptim

from repro_torch import bridge
from repro_torch.core import model as taf2
from repro_torch.data import bucketing as tbk
from repro_torch.data import ingest as tingest
from repro_torch.data.pipeline import TRAIN_BATCH_KEYS
from repro_torch.data.protein import protein_batch
from repro_torch.train import optim as toptim
from repro_torch.train.trainstep import init_state, make_af2_train_step

from torch_util import af2_tree, np_tree, port_cfg, randomize_np

CFG = af2_tiny()
PCFG = port_cfg(CFG)
LOSS_RTOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4, 1e-3


def jax_loss(params, batch, n_recycle):
    """``repro.core.model.loss_fn`` at fp32: ``forward(dtype=float32)`` plus
    the same four losses with the same weights; (total, the terms)."""
    out = jaf2.forward(params, CFG, batch, n_recycle=n_recycle,
                       dtype=jnp.float32)
    res_mask = batch["res_mask"].astype(jnp.float32)
    rots_traj, trans_traj = out["traj"]
    l_fape = jheads.fape_loss(rots_traj, trans_traj, batch["true_rots"],
                              batch["true_trans"], res_mask)
    l_dist = jheads.distogram_loss(
        jheads.distogram_logits(params["heads"], out["z"]),
        batch["true_trans"], res_mask, n_bins=CFG.n_distogram_bins)
    l_msa = jheads.masked_msa_loss(
        jheads.masked_msa_logits(params["heads"], out["msa"]),
        batch["true_msa"], batch["msa_mask_positions"].astype(jnp.float32))
    l_plddt = jheads.plddt_loss(
        jheads.plddt_logits(params["heads"], out["s_final"]), out["trans"],
        batch["true_trans"], res_mask, n_bins=CFG.n_plddt_bins)
    total = 0.5 * l_fape + 0.3 * l_dist + 2.0 * l_msa + 0.01 * l_plddt
    return total, {"fape": l_fape, "distogram": l_dist, "masked_msa": l_msa,
                   "plddt": l_plddt}


# every protein shorter than af2_tiny's 16 residues: the record path pads
# each onto the training bucket with res_mask 0, identity frames and no
# masked MSA positions
PADDED_FASTA = ">short_a\nMKVLAAGICWTE\n>short_b\nGSHMRDLY\n"


def padded_batch() -> dict:
    """The batch the record pipeline gives training (its keys only)."""
    src = tingest.FastaSource(PADDED_FASTA, PCFG)
    bucket = tbk.train_bucket(PCFG)
    batch = tbk.stack_batch([
        tbk.pad_record_to_bucket(
            tingest.featurize_record(src.record(i), PCFG, seed=3, idx=i),
            bucket) for i in range(len(src))])
    return {k: batch[k] for k in TRAIN_BATCH_KEYS}


@pytest.fixture(scope="module")
def setup():
    params = randomize_np(af2_tree(CFG), seed=5)
    batches = {"synthetic": protein_batch(0, 0, 2, PCFG),
               "padded": padded_batch()}
    vg = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))
    return params, batches, vg, {}


def _sample(batch, b):
    return {k: v[b] for k, v in batch.items()}


def _jax_grads(setup, b, n_recycle, which="synthetic"):
    """(loss, terms, grads) of the reference for protein ``b`` of a batch,
    computed once per (batch, protein, n_recycle)."""
    params, batches, vg, memo = setup
    key = (which, b, n_recycle)
    if key not in memo:
        (loss, terms), grads = vg(
            params, {k: jnp.asarray(v) for k, v in
                     _sample(batches[which], b).items()},
            jnp.asarray(n_recycle, jnp.int32))
        memo[key] = (float(loss), {k: float(v) for k, v in terms.items()},
                     np_tree(grads))
    return memo[key]


def _port_model(params):
    model = taf2.AlphaFold2(PCFG, device="cpu")
    return bridge.load_jax_params(model, params)


def _assert_grads_close(got: dict, want_tree: dict):
    want = bridge.params_to_state_dict(want_tree)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].detach().float()
        tol = GRAD_ATOL * max(1.0, w.abs().max().item()) + GRAD_RTOL * w.abs()
        assert bool(((g - w).abs() <= tol).all()), (
            k, (g - w).abs().max().item(), w.abs().max().item())


@pytest.mark.parametrize("n_recycle", [1, 2])
def test_loss_and_every_gradient_match_jax_fp32(setup, n_recycle):
    params, batches, _, _ = setup
    batch = batches["synthetic"]
    want_loss, _, want_grads = _jax_grads(setup, 0, n_recycle)
    model = _port_model(params)
    loss, metrics = taf2.loss_fn(model, PCFG, _sample(batch, 0),
                                 n_recycle=n_recycle, dtype=torch.float32)
    loss.backward()
    assert abs(loss.item() - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert set(metrics) == {"loss", "fape", "distogram", "masked_msa", "plddt"}
    got = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
           for k, p in model.named_parameters()}
    _assert_grads_close(got, want_grads)


def test_per_sample_clip_matches_oracle(setup):
    """``make_af2_train_step`` with ``sgd(per_sample_clip=0.1)`` on a batch of
    two proteins against the oracle of tests/test_trainer.py: clip EACH
    protein's JAX gradient at 0.1, average, step (sgd without momentum moves
    the parameters by exactly lr * grads)."""
    clip, lr = 0.1, 0.05
    params, batches, _, _ = setup
    batch = batches["synthetic"]
    gs = [_jax_grads(setup, b, 1)[2] for b in range(2)]
    # one compiled oracle (op by op, JAX compiles each op for each leaf shape)
    norm_and_clip = jax.jit(lambda g: (joptim.global_norm(g),
                                       joptim.clip_by_global_norm(g, clip)[0]))
    norms, clipped = zip(*((float(n), np_tree(c)) for n, c in
                           map(norm_and_clip, gs)))
    assert max(norms) > clip * 0.99           # clipping actually engaged
    expect = jax.tree_util.tree_map(lambda p, a, b: p - lr * (a + b) / 2.0,
                                    params, *clipped)

    model = _port_model(params)
    opt = toptim.sgd(lr, per_sample_clip=clip)
    step = make_af2_train_step(PCFG, opt, device="cpu", dtype=torch.float32)
    state, metrics = step(init_state(model, opt), batch, 0)
    assert state["opt"].step == 1 and np.isfinite(metrics["loss"])
    want = bridge.params_to_state_dict(expect)
    start = bridge.params_to_state_dict(params)
    for k, p in model.named_parameters():
        moved = (want[k] - start[k]).abs().max().item()
        err = (p.detach() - want[k]).abs().max().item()
        # the step moves a leaf by at most lr * clip = 5e-3; hold the port's
        # move to the oracle's within the gradient tolerance times lr
        assert err <= lr * (GRAD_ATOL + GRAD_RTOL * moved / lr) + 1e-7, (
            k, err, moved)


def test_padded_residue_loss_terms_and_gradients_match_jax_fp32(setup):
    """A record-path batch (FASTA records of 12 and 8 residues padded onto
    the 16-residue bucket): the total loss and each of its four terms, and
    every gradient leaf and the gradient's global norm, against the
    reference's ``loss_fn`` at fp32, at this module's tolerances."""
    params, batches, _, _ = setup
    batch = batches["padded"]
    assert (batch["res_mask"].sum(1) < PCFG.n_res).all()
    assert not batch["msa_mask_positions"][:, :, 12:].any()
    model = _port_model(params)
    for b in range(2):
        want_loss, want_terms, want_grads = _jax_grads(setup, b, 1, "padded")
        model.zero_grad(set_to_none=True)
        loss, metrics = taf2.loss_fn(model, PCFG, _sample(batch, b),
                                     n_recycle=1, dtype=torch.float32)
        loss.backward()
        assert abs(loss.item() - want_loss) <= LOSS_RTOL * abs(want_loss)
        for k, want in want_terms.items():
            assert abs(metrics[k].item() - want) <= LOSS_RTOL * abs(want), (
                b, k, metrics[k].item(), want)
        got = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
               for k, p in model.named_parameters()}
        _assert_grads_close(got, want_grads)
        want_norm = float(np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                                      for g in bridge.flatten(want_grads)
                                      .values())))
        got_norm = toptim.global_norm(got).item()
        assert abs(got_norm - want_norm) <= LOSS_RTOL * want_norm + GRAD_ATOL
