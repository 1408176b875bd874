"""Program capture for the lint CLI: trace the port's REAL train and fold
steps (counterpart of ``repro/analysis/static/program.py``).

The reference lowers its steps abstractly; the port has no abstract
tracing, so each capture RUNS the step once, on fresh state at the lint
config, under an op trace (``op_walk``), and throws the state away.  A
capture takes a fraction of a second on the CPU at this size.

LINT_CFG_NOTES — why the lint config is not plain af2_tiny (the
reference's reasons, unchanged)
----------------------------------------------------------------------
The materialization pass compares op-output element counts against the
fused-impl bounds, so the bounds must sit strictly ABOVE every legitimate
intermediate, and the sequence extents must not collide with channel dims
(the precision pass keys on "contracts over a sequence extent").  At
af2_tiny sizes both fail (c_opm^2 == 4*c_z == 64; n_res == c_z == 16), so
lint runs af2_tiny with:

  * n_res=24, n_seq=20, n_extra_seq=12 — distinct from every channel dim
  * c_hidden_opm=16  -> OPM bound  r*r*c^2      = 147456
  * c_hidden_mul=80  -> tri bound  r*r*2*c_mul  =  92160 (K3-K5 take
    c_mul 80, a multiple of 16, so the card runs it too)
  * opm/attention/tri chunks = 4 — the fused OPM's row chunk; the
    attention and triangle chunks are the reference's and unused here
    (the port's kernels hold no score tensor or gated pair at all)
  * structure n_head=3 — distinct from the Evoformer head counts: the IPA
    scalar attention materializes its (h, r, r) scores BY DESIGN, and the
    full-score detector keys on Evoformer head counts
  * the port's kernel impls (``with_kernels``): attention ``evo_pallas``
    (K1 / K2), triangle ``pallas`` (K3-K5)

The largest legitimate intermediate is the MSA transition's
(s, r, 4*c_m) = 20*24*128 = 61440 elements, below both bounds.

Rank processes.  The ranks of a world of ``world`` rank processes tile it
with world / n meshes of an n-rank plan (a 2-rank plan on ranks 0-1 and on
ranks 2-3), and every rank builds every mesh in the same order, since a
mesh creates process groups.  The copies would run the same program, so
one copy captures it: the k-th program of the matrix goes to mesh k mod
world / n (rank k mod world for a one-device plan), and the copies' ranks
capture side by side.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis.static import op_walk
from repro_torch.analysis.static.core import Program


def lint_config(variant: str = "parallel"):
    from repro_torch.core.config import af2_tiny, with_kernels
    base = af2_tiny(variant=variant)
    tweak = dict(c_hidden_opm=16, c_hidden_mul=80, opm_chunk=4,
                 attention_chunk=4, tri_mult_chunk=4)
    return with_kernels(dataclasses.replace(
        base,
        evoformer=dataclasses.replace(base.evoformer, **tweak),
        extra=dataclasses.replace(base.extra, **tweak),
        structure=dataclasses.replace(base.structure, n_head=3),
        n_res=24, n_seq=20, n_extra_seq=12))


# ---------------------------------------------------------------------------
# The plan matrix (the reference's: serial, BP, DAP, hybrid, overlap on/off)
# ---------------------------------------------------------------------------

def train_plan_matrix():
    """[(name, ParallelPlan, per_sample_clip)] — every layout family.  The
    hybrid runs the per-sample-clip optimizer so the per-protein completion
    path of the train step is audited too."""
    from repro_torch.parallel.plan import ParallelPlan
    return [
        ("serial", ParallelPlan(data=2), None),
        ("bp2", ParallelPlan(branch=2, variant="parallel"), None),
        ("dap2", ParallelPlan(dap=2), None),                  # overlap auto-ON
        ("dap2_sync", ParallelPlan(dap=2, overlap_dap=False), None),
        ("hybrid", ParallelPlan(branch=2, dap=2, variant="parallel"), 0.1),
    ]


def fold_plan_matrix():
    from repro_torch.parallel.plan import ParallelPlan
    return [
        ("serial", ParallelPlan(), "float32"),
        ("serial_bf16", ParallelPlan(), "bfloat16"),
        ("dap2", ParallelPlan(dap=2, overlap_dap=True), "float32"),
    ]


def rank_groups(n: int, world: int) -> list:
    """The meshes (global rank lists) that tile ``world`` ranks with copies
    of an ``n``-rank plan; [None] for a one-device plan (no mesh)."""
    if n == 1:
        return [None]
    if world % n:
        raise ValueError(f"a plan of {n} ranks does not tile a world of "
                         f"{world}: run the lint over a multiple of {n} "
                         "ranks (--devices)")
    return [list(range(i, i + n)) for i in range(0, world, n)]


def _captures(groups: list, k: int, rank: int, world: int) -> bool:
    """Whether ``rank`` captures the ``k``-th program of the matrix, whose
    plan ``groups`` tile the world: the ranks of mesh k mod len(groups),
    or rank k mod ``world`` for a one-device plan."""
    if groups[0] is None:
        return rank == k % world
    return rank in groups[k % len(groups)]


def _world() -> tuple:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def state_tensors(state: dict) -> dict:
    """Every tensor of a train state by key: the parameters, the optimizer
    moments, the EMA and the error feedback."""
    out = {f"params.{k}": p for k, p in state["params"].named_parameters()}
    opt = state["opt"]
    for field in opt._fields:
        val = getattr(opt, field)
        if isinstance(val, dict):
            out.update({f"opt.{field}.{k}": t for k, t in val.items()
                        if isinstance(t, torch.Tensor)})
    for key in ("ema", "err"):
        out.update({f"{key}.{k}": t for k, t in state.get(key, {}).items()})
    return out


# ---------------------------------------------------------------------------
# Train capture
# ---------------------------------------------------------------------------

def _grad_nocomplete(model, cfg, built, batch, key):
    """The missing-completion bug, reconstructed on purpose: this rank's
    loss gradient with the DP mean but WITHOUT ``complete_partial_grads``
    over the branch / dap sync axes.  The collectives audit requires the
    real step to carry strictly more psums per sync axis than this null
    hypothesis (psum's backward is a psum)."""
    from repro_torch.core import evoformer as evo
    from repro_torch.core import model as af2
    from repro_torch.parallel import collectives as coll
    from repro_torch.train.trainstep import param_dict
    params = param_dict(model)
    n = batch["target_feat"].shape[0]
    acc = {k: torch.zeros_like(p) for k, p in params.items()}
    for b in range(n):
        for p in params.values():
            p.grad = None
        path = (built.dp_rank, b) if built.dp_size > 1 else (b,)
        loss, _ = af2.loss_fn(model, cfg, {k: v[b] for k, v in batch.items()},
                              n_recycle=1, rng=evo.Key(key, path),
                              deterministic=False, dtype=torch.bfloat16,
                              block_fn=built.block_fn,
                              stack_io=built.stack_io)
        loss.backward()
        for k, p in params.items():
            if p.grad is not None:
                acc[k].add_(p.grad.float())
    for p in params.values():
        p.grad = None
    grads = {k: g / n for k, g in acc.items()}
    # BUG (deliberate): no complete_partial_grads(grads, sync axes)
    return coll.pmean_tree(grads, [built.axis(a) for a in built.dp_axes])


def capture_train(name, plan, cfg, *, per_sample_clip=None, device="cpu",
                  ranks: Optional[list] = None) -> Program:
    """Trace one real bf16 training step (AdamW, dropout on, one recycle
    cycle) of ``plan`` at ``cfg`` on fresh state over the global ``ranks``
    (None: the whole world; every rank of the world calls this together), plus
    the ``grad_nocomplete`` baseline when the plan has sync axes.  Roles:
    ``step``; ``fwd``, the forward of the first loss (the step's records
    before its first backward op); ``grad_nocomplete``, whose collectives
    are all the audit reads, so its trace keeps the port's nodes only (no
    aten ops)."""
    from repro_torch.data.protein import protein_batch
    from repro_torch.train.optim import adamw
    from repro_torch.train.trainer import TrainRunner

    plan.validate(cfg)
    runner = TrainRunner(
        cfg, plan, ranks=ranks,
        optimizer=adamw(1e-3, per_sample_clip=per_sample_clip),
        batch_size=plan.pod * plan.data, seed=0, recycle_sample=False,
        n_recycle=1, ema_decay=None, deterministic=False, device=device,
        graphs=False, dtype=torch.bfloat16)
    built = runner.built
    batch = protein_batch(0, 0, runner.batch_size, runner.cfg)
    tensors = runner.step_args(0, batch)
    before = {k: t.data_ptr() for k, t in state_tensors(runner.state).items()}
    step_trace, _ = op_walk.capture(runner.step_for(1), *tensors)
    after = state_tensors(runner.state)
    rebound = sorted(k for k, t in after.items()
                     if before.get(k) != t.data_ptr())
    traces = {"step": step_trace}
    if built.sync_axes:
        keys = runner.batch_keys
        local = dict(zip(keys, tensors[:len(keys)]))
        base, _ = op_walk.capture(
            _grad_nocomplete, runner.model, runner.cfg, built, local,
            tensors[len(keys)], static=(0, 1, 2), ops=False)
        traces["grad_nocomplete"] = base
    traces["fwd"] = step_trace.forward_prefix()
    return Program(
        name=f"train:{name}", kind="train", traces=traces,
        # a data axis of extent 1 (every mesh names one) reduces nothing:
        # a collective over it is the identity and issues nothing
        meta={"cfg": runner.cfg, "plan": plan.describe(),
              "sync_axes": built.sync_axes,
              "dp_axes": tuple(a for a in built.dp_axes
                               if built.axis(a).size > 1),
              "device": str(runner.device),
              "steps_built": runner.train_compiles, "draws": 1,
              "rebound": rebound,
              "expect_overlap": plan.resolve_overlap(runner.cfg)})


# ---------------------------------------------------------------------------
# Fold capture
# ---------------------------------------------------------------------------

def capture_fold(name, plan, cfg, *, dtype="float32", device="cpu",
                 ranks: Optional[list] = None, model=None,
                 kernel_nodes: bool = True) -> Program:
    """Trace one bucket step of the fold engine (``fold_steps.
    make_fold_step``, one recycle cycle, tol 0) under ``plan``'s inference
    layout at the bucket of ``cfg``; ``model``: the weights (None: fresh
    ones from seed 0)."""
    from repro_torch.core.model import AlphaFold2
    from repro_torch.serve import fold_steps as fs

    inf = plan.for_inference()
    bucket = fs.Bucket(cfg.n_res, cfg.n_seq, cfg.n_extra_seq)
    bcfg = inf.apply_to(fs.bucket_cfg(cfg, bucket))
    built = inf.build(ranks, cfg=bcfg, device=device)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    step = fs.make_fold_step(bcfg, built, max_recycle=1, tol=0.0, dtype=tdt)
    if model is None:
        model = AlphaFold2(bcfg, seed=0, device=device)
    smp = fs.pad_to_bucket({
        "msa_feat": np.zeros((bcfg.n_seq, bcfg.n_res, bcfg.msa_feat_dim),
                             np.float32),
        "extra_msa_feat": np.zeros(
            (bcfg.n_extra_seq, bcfg.n_res, bcfg.msa_feat_dim), np.float32),
        "target_feat": np.zeros((bcfg.n_res, bcfg.target_feat_dim),
                                np.float32),
        "residue_index": np.arange(bcfg.n_res, dtype=np.int32),
    }, bucket)
    # batch slots: >= n_devices, but never equal to a head count, as the
    # reference picks them (disambiguate by construction)
    heads = {cfg.evoformer.n_head_msa, cfg.evoformer.n_head_pair,
             cfg.extra.n_head_msa, cfg.extra.n_head_pair}
    bsz = max(1, inf.n_devices)
    while bsz in heads:
        bsz += 1
    batch = fs.stack_padded([smp], bsz)
    trace, _ = op_walk.capture(step, model, batch, kernel_nodes=kernel_nodes)
    return Program(
        name=f"fold:{name}", kind="fold",
        traces={"step": trace, "fwd": trace},
        meta={"cfg": bcfg, "plan": inf.describe(),
              "sync_axes": built.sync_axes, "dp_axes": built.dp_axes,
              "device": str(device),
              "expect_overlap": inf.resolve_overlap(bcfg)})


def capture_all(*, only=None, device="cpu") -> list:
    """The programs of the matrix that this rank captures, in matrix order
    (every rank of the world calls this together; each program is captured
    by one copy of its plan).  ``only`` filters by substring match on the
    program name (e.g. 'dap2', 'fold:'); a program this rank's world cannot
    tile raises."""
    rank, world = _world()
    cfg = lint_config()
    matrix = [(f"train:{name}", name, plan, plan, clip)
              for name, plan, clip in train_plan_matrix()]
    matrix += [(f"fold:{name}", name, plan, plan.for_inference(), dtype)
               for name, plan, dtype in fold_plan_matrix()]
    out = []
    for k, (full, name, plan, layout, arg) in enumerate(matrix):
        if only and only not in full:
            continue
        groups = rank_groups(layout.n_devices, world)
        mine = _captures(groups, k, rank, world)
        for g in groups:
            if mine and (g is None or rank in g):
                out.append(
                    capture_train(name, plan, cfg, per_sample_clip=arg,
                                  device=device, ranks=g)
                    if full.startswith("train:") else
                    capture_fold(name, plan, cfg, dtype=arg, device=device,
                                 ranks=g))
            elif g is not None:     # another copy: its process groups only
                layout.build(g, cfg=cfg, device=device)
    return out
