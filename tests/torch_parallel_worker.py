"""Rank program of ``tests/test_torch_parallel_ranks.py``: four gloo ranks on
the CPU, fp32, deterministic, af2_tiny.  Imports no JAX (the ranks are new
processes; the test holds their results against the JAX package).

Every rank builds every plan's mesh in the same order (a mesh creates
process groups); two-rank plans run side by side, BP on ranks 0-1 and DAP
on ranks 2-3.  Each rank returns a dict of numpy results."""
import dataclasses

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.core import model as taf2
from repro_torch.data.protein import protein_batch
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.grad_sync import (compressed_psum_tree,
                                            zeros_error_state)
from repro_torch.parallel.mesh_utils import (local_slice, make_mesh,
                                             mesh_shape, refactor_mesh,
                                             rename_mesh)
from repro_torch.parallel.plan import ParallelPlan
from repro_torch.train.checkpoint import PlanMismatchError
from repro_torch.train.optim import sgd
from repro_torch.train.trainer import TrainRunner
from repro_torch.train.trainstep import init_state, make_af2_train_step


def _np(t):
    return t.detach().float().numpy().copy()


def _grad(t):
    """``t``'s gradient; zeros where this rank's branch never read ``t``."""
    return _np(t.grad) if t.grad is not None else np.zeros(
        tuple(t.shape), np.float32)


def _model(cfg, params):
    return bridge.load_jax_params(taf2.AlphaFold2(cfg, device="cpu"), params)


def _stack(built, blocks, ev, msa, z):
    """(msa, z) through the plan's stack_io and block_fn: the full outputs."""
    pre, post = built.stack_io or ((lambda m, zz: (m, zz)),) * 2
    m_l, z_l = pre(msa, z)
    m_l, z_l = taf2.evoformer_stack(blocks, ev, m_l, z_l,
                                    block_fn=built.block_fn)
    return post(m_l, z_l)


def _partial_grads(built, block, ev, msa, z):
    """This rank's gradients of sum(msa_out^2) + sum(z_out^2) through one
    block, before completion: the block's parameters and the inputs
    (``built`` None: the serial block)."""
    m = msa.clone().requires_grad_(True)
    zz = z.clone().requires_grad_(True)
    blocks = torch.nn.ModuleList([block])
    if built is None:
        mo, zo = taf2.evoformer_stack(blocks, ev, m, zz)
    else:
        mo, zo = _stack(built, blocks, ev, m, zz)
    ((mo ** 2).sum() + (zo ** 2).sum()).backward()
    out = {f"p.{k}": _grad(p) for k, p in block.named_parameters()}
    out.update({"msa": _grad(m), "z": _grad(zz)})
    block.zero_grad(set_to_none=True)
    return out


def _sgd_step(rank, plan, ranks, cfg, params, batch):
    """One SGD step of the whole model under ``plan`` over ``ranks`` (every
    rank builds it; the plan's ranks run it), or None off the plan."""
    opt = sgd(0.1)
    step = make_af2_train_step(cfg, opt, plan, ranks=ranks, device="cpu",
                               dtype=torch.float32)
    if ranks is not None and rank not in ranks:
        return None
    model = _model(cfg, params)
    state = init_state(model, opt, compress_err=plan.compress_pod_grads)
    state, metrics = step(state, batch, 0)
    out = {"loss": metrics["loss"],
           "params": {k: _np(p) for k, p in model.named_parameters()}}
    if "err" in state:
        out["err"] = {k: _np(e) for k, e in state["err"].items()}
    return out


def run(rank, world, device, inp):
    cfg, cfg_sgd = inp["cfg"], inp["cfg_sgd"]
    ev = cfg.evoformer
    res = {}
    model = _model(cfg, inp["params"])
    blocks = model.evoformer
    msa, z = torch.from_numpy(inp["msa"]), torch.from_numpy(inp["z"])

    # every mesh, on every rank, in one order
    plans = {
        "bp": ParallelPlan(branch=2).build([0, 1], cfg=cfg),
        "dap_sync": ParallelPlan(dap=2, overlap_dap=False).build([2, 3],
                                                                 cfg=cfg),
        "dap_overlap": ParallelPlan(dap=2).build([2, 3], cfg=cfg),
        "hybrid": ParallelPlan(branch=2, dap=2).build(cfg=cfg),
        "data2_bp2": ParallelPlan(data=2, branch=2).build(cfg=cfg),
        "pod": ParallelPlan(pod=4).build(cfg=cfg),
    }
    mine = {k: b for k, b in plans.items() if b.in_mesh}
    model_mesh = make_mesh((1, 4), ("data", "model"))
    split = refactor_mesh(model_mesh, {"model": [("branch", 2), ("dap", 2)]})
    adapted = ParallelPlan(branch=2, dap=2).build(model_mesh, cfg=cfg)
    renamed = rename_mesh(split, {"dap": "seq"})
    res["meshes"] = {"split": (mesh_shape(split), split.mesh.flatten().tolist()),
                     "adapted": mesh_shape(adapted.mesh),
                     "renamed": mesh_shape(renamed)}
    res["overlap_resolved"] = plans["dap_overlap"].plan.resolve_overlap(cfg)

    # stack outputs (2 blocks, no gradient); DAP also on the serial variants
    with torch.no_grad():
        for variant in ("af2", "multimer"):
            ev_v = dataclasses.replace(ev, variant=variant)
            if rank == 0:
                m, zz = taf2.evoformer_stack(blocks, ev_v, msa, z)
                res[f"stack.serial_{variant}"] = (_np(m), _np(zz))
            if "dap_sync" in mine:
                m, zz = _stack(mine["dap_sync"], blocks, ev_v, msa, z)
                res[f"stack.dap_{variant}"] = (_np(m), _np(zz))
        if rank == 0:
            m, zz = taf2.evoformer_stack(blocks, ev, msa, z)
            res["stack.serial"] = (_np(m), _np(zz))
        for name in ("bp", "dap_sync", "dap_overlap", "hybrid"):
            if name in mine:
                m, zz = _stack(mine[name], blocks, ev, msa, z)
                res[f"stack.{name}"] = (_np(m), _np(zz))

    # the naive OPM under DAP on dap_sync's ranks, masked rows: the
    # gathered (r, r, c_z) update
    if "dap_sync" in mine:
        from repro_torch.parallel import dap
        ax = mine["dap_sync"].axis("dap")
        with torch.no_grad():
            out = dap.dap_outer_product_mean(
                blocks[0].opm, local_slice(msa, ax, 0), ax, opm_impl="naive",
                row_mask=torch.from_numpy(inp["opm_rows"]))
            res["opm.dap_naive"] = _np(coll.all_gather(out, ax, 0))

    # each rank's partial gradients through one block
    if rank == 0:
        res["grads.serial"] = _partial_grads(None, blocks[0], ev, msa, z)
    for name in ("bp", "dap_sync"):
        if name in mine:
            res[f"grads.{name}"] = _partial_grads(mine[name], blocks[0], ev,
                                                  msa, z)

    # collective counts of one block, forward
    with torch.no_grad():
        for name in ("bp", "dap_sync", "dap_overlap"):
            if name not in mine:
                continue
            built = mine[name]
            m_l, z_l = built.stack_io[0](msa, z)
            zf = (coll.all_gather(z_l, built.axis("dap"), 0)
                  if name == "dap_overlap" else None)
            coll.reset_counts()
            if zf is None:
                built.block_fn(blocks[0], ev, m_l, z_l)
                res[f"counts.{name}"] = coll.counts()
            else:
                *_, pending = built.block_fn(blocks[0], ev, m_l, z_l,
                                             prefetch=zf)
                res[f"counts.{name}"] = coll.counts()
                pending.wait()

    # one SGD step of the whole model under each plan (global batch 2)
    batch = protein_batch(0, 0, 2, cfg_sgd)
    if rank == 0:
        res["sgd.serial"] = _sgd_step(rank, ParallelPlan(), None, cfg_sgd,
                                      inp["params_sgd"], batch)
    for name, kw, r in (
            ("bp2", {"branch": 2}, [0, 1]), ("dap2", {"dap": 2}, [2, 3]),
            ("bp2_dap2", {"branch": 2, "dap": 2}, None),
            ("data2_bp2", {"data": 2, "branch": 2}, None),
            ("pod2_bp2_compressed", {"pod": 2, "branch": 2,
                                     "compress_pod_grads": True}, None)):
        out = _sgd_step(rank, ParallelPlan(**kw), r, cfg_sgd,
                        inp["params_sgd"], batch)
        if out is not None:
            res[f"sgd.{name}"] = out

    # int8 error-feedback pod sum, two rounds
    pod = plans["pod"].axis("pod")
    g = {k: torch.from_numpy(v[rank]) for k, v in inp["pod_grads"].items()}
    red1, err1 = compressed_psum_tree(g, pod, zeros_error_state(g))
    red2, _ = compressed_psum_tree(g, pod, err1)
    res["compress"] = {"red1": {k: _np(v) for k, v in red1.items()},
                       "err1": {k: _np(v) for k, v in err1.items()},
                       "red2": {k: _np(v) for k, v in red2.items()}}

    # checkpoint metadata: written under DAP 2 by the mesh's first rank,
    # refused under data parallelism 2 on the same ranks
    # (each TrainRunner builds its plan's mesh: the other ranks build the
    # same meshes in the same order)
    if "dap_sync" in mine:
        kw = dict(device="cpu", ckpt_dir=inp["ckpt_dir"], seed=3,
                  recycle_sample=False)
        a = TrainRunner(cfg_sgd, ParallelPlan(dap=2), ranks=[2, 3], **kw)
        a.save()
        a.mgr.wait()
        ck = {"writer": a.built.is_writer, "restored": a.restore()}
        b = TrainRunner(cfg_sgd, ParallelPlan(data=2), ranks=[2, 3], **kw)
        try:
            b.restore()
            ck["refused"] = False
        except PlanMismatchError:
            ck["refused"] = True
        ck["adapted"] = b.restore(adapt_plan=True)
        res["ckpt"] = ck
    else:
        ParallelPlan(dap=2).build([2, 3], cfg=cfg_sgd)
        ParallelPlan(data=2).build([2, 3], cfg=cfg_sgd)
        res["ckpt"] = None

    # TrainRunner: one step and one evaluation under BP 2 x DAP 2 against
    # the one-device runner (dropout on: BP and DAP draw the serial masks)
    kw = dict(device="cpu", seed=5, recycle_sample=False, eval_batch_size=2,
              dtype=torch.float32)
    hy = TrainRunner(cfg_sgd, ParallelPlan(branch=2, dap=2), **kw)
    hy.run(1)
    res["runner.hybrid"] = {"loss": hy.history["loss"][0],
                            "lddt": hy.evaluate()["lddt_ca"]}
    if rank == 0:
        se = TrainRunner(cfg_sgd, **kw)
        se.run(1)
        res["runner.serial"] = {"loss": se.history["loss"][0],
                                "lddt": se.evaluate()["lddt_ca"]}
    return res
