"""Rank program of ``tests/test_torch_lm_fsdp.py``: two gloo ranks on the
CPU, the LM families at their reduced widths with ``fsdp=True``, every
family's compute under an fp32 policy.  Imports no JAX.

Each case runs one step of ``make_lm_train_step`` over the (2, 1) mesh
over ("data", "model") from the same seeded init and the same batch as
the one-device step, which rank 0 also runs; rank 0 returns the gathered
parameters and moments, each rank its local shapes and layout."""
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import dense, get_model
from repro_torch.models.lmconfig import with_kernels
from repro_torch.nn.layers import Policy
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.mesh_utils import Axis, make_mesh
from repro_torch.train import trainstep as ts
from repro_torch.train.checkpoint import (CheckpointManager,
                                          restore_checkpoint,
                                          train_state_tree)
from repro_torch.train.optim import sgd
from repro_torch import bridge

F32 = Policy(compute_dtype=torch.float32)
LR, CLIP = 0.5, 1.0


def case_cfg(case):
    cfg = with_kernels(configs.get_smoke_config(case["arch"]))
    return dataclasses.replace(cfg, fsdp=True, **case.get("overrides", {}))


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def _one_device(lm, cfg, case):
    """(loss, grad_norm, params after the step) of the one-device step."""
    model = lm.init_params(cfg, seed=0, device="cpu")
    opt = sgd(LR, momentum=0.9, clip_norm=CLIP)
    step = ts.make_lm_train_step(lm, cfg, opt,
                                 microbatch=case.get("microbatch"))
    state, m = step(ts.init_lm_state(model, opt), _batch(case))
    return (m["loss"].item(), m["grad_norm"].item(),
            {k: _np(p) for k, p in model.named_parameters()})


def _batch(case):
    return {k: torch.from_numpy(v) for k, v in case["batch"].items()}


def run_case(rank, mesh, case, ckpt_dir=None):
    cfg = case_cfg(case)
    lm = get_model(cfg)
    lm.BF16 = F32
    model = lm.init_params(cfg, seed=0, device="cpu")
    p0 = {k: _np(p) for k, p in model.named_parameters()}
    opt = sgd(LR, momentum=0.9, clip_norm=CLIP)
    layout = ts.lm_layout(lm, cfg, model, mesh)
    state = ts.init_lm_state(model, opt, layout=layout)
    step = ts.make_lm_train_step(lm, cfg, opt, mesh,
                                 microbatch=case.get("microbatch"))
    coll.reset_counts()
    state, m = step(state, _batch(case))
    out = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
           "counts": coll.counts(), "dims": dict(layout.dims),
           "shapes": dict(layout.shapes),
           "local": {k: tuple(p.shape) for k, p in model.named_parameters()},
           "mu_local": {k: tuple(t.shape) for k, t in state["opt"].mu.items()}}
    full = ts.lm_full_state(state)
    if ckpt_dir is not None:
        mgr = CheckpointManager(ckpt_dir, write=rank == 0, async_save=False)
        mgr.save(1, train_state_tree(full, stacked=bridge.LM_STACKED))
    if rank == 0:
        out["params"] = {k: _np(t) for k, t in full["params"].items()}
        out["mu"] = {k: _np(t) for k, t in full["opt"].mu.items()}
        out["p0"] = p0
        out["one"] = _one_device(lm, cfg, case)
    return out


def restore_case(mesh, case, ckpt_dir):
    """A fresh sharded state restored from a one-device checkpoint: this
    rank's parameter and moment slices."""
    cfg = case_cfg(case)
    lm = get_model(cfg)
    model = lm.init_params(cfg, seed=1, device="cpu")
    opt = sgd(LR, momentum=0.9)
    state = ts.init_lm_state(model, opt,
                             layout=ts.lm_layout(lm, cfg, model, mesh))
    full = ts.lm_full_state_like(state)
    restored, step = restore_checkpoint(ckpt_dir, train_state_tree(
        full, stacked=bridge.LM_STACKED))
    full["opt"] = full["opt"]._replace(step=restored["opt"].step)
    ts.load_lm_full_state_(state, full)
    return {"step": step, "opt_step": state["opt"].step,
            "params": {k: _np(p) for k, p in model.named_parameters()},
            "mu": {k: _np(t) for k, t in state["opt"].mu.items()}}


def bp_case(rank, case):
    """``bp_parallel_layer`` over a branch axis of the two ranks against
    ``layer_apply`` on the same layer and input."""
    cfg = case_cfg(case)
    cfg = dataclasses.replace(cfg, parallel_block=True, fsdp=False)
    layer = dense.Layer(cfg, generator=torch.Generator().manual_seed(4))
    x = torch.from_numpy(case["x"])
    pos = torch.arange(x.shape[1], dtype=torch.int32).expand(x.shape[0], -1)
    axis = Axis(make_mesh((2,), ("branch",)), "branch")
    coll.reset_counts()
    got, none = dense.bp_parallel_layer(layer, cfg, x, pos, axis=axis)
    counts = coll.counts()
    want, _ = dense.layer_apply(layer, cfg, x, pos)
    serial = dataclasses.replace(cfg, parallel_block=False)
    try:
        dense.bp_parallel_layer(layer, serial, x, pos, axis=axis)
        refused = False
    except ValueError:
        refused = True
    return {"diff": (got - want).abs().max().item(), "none": none is None,
            "counts": counts, "refused": refused}


def run(rank, world, device, inp):
    dense.BF16 = F32
    mesh = make_mesh((world, 1), ("data", "model"))
    res = {}
    for name, case in inp["cases"].items():
        res[name] = run_case(rank, mesh, case,
                             inp["ckpt_two"] if name == "dense" else None)
    res["restore"] = restore_case(mesh, inp["cases"]["dense"],
                                  inp["ckpt_one"])
    res["bp"] = bp_case(rank, inp["bp"])
    return res


def batch_np(cfg, n: int, s: int, seed: int, mask=None) -> dict:
    """A numpy batch of ``n`` rows of ``s`` tokens (plus frames / patches)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (n, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (n, s)).astype(np.int32)}
    key = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    if key:
        out[key] = rng.standard_normal(
            (n, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if mask is not None:
        out["mask"] = mask
    return out
