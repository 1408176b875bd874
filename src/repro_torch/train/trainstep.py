"""The AlphaFold2 training step (counterpart of
``repro/train/trainstep.py::make_af2_train_step``), laid out by a
``parallel.plan.ParallelPlan``: on one device by default, or on this rank's
share of a plan over rank processes — its data-parallel rows of the batch,
its branch (BP) or activation shard (DAP) of each protein through the
plan's ``block_fn`` / ``stack_io``, and the plan's gradient completion and
reduction (``grad_sync``).

The step's body (:func:`make_step_body`) is a function of tensors only:
the batch, the dropout key and the optimizer's step count come in as
device tensors, the parameters, moments and EMA are updated in place, and
the metrics go out as 0-d tensors.  It reads nothing back to the host and
copies nothing from it, so ``TrainRunner`` can capture it as a CUDA graph
(one per drawn ``n_recycle``) and replay it with new inputs;
:func:`make_af2_train_step` runs it eagerly.
"""
from __future__ import annotations

import torch

from repro_torch.core import evoformer as evo
from repro_torch.core import model as af2
from repro_torch.device import resolve_device
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.plan import (BuiltPlan, ParallelPlan, as_plan,
                                       complete_partial_grads)
from repro_torch.train.optim import (Ema, Optimizer, clip_by_global_norm,
                                    global_norm)

# the step's outputs, in this order
METRICS = ("loss", "fape", "distogram", "masked_msa", "plddt", "grad_norm",
           "sample_grad_norm")


def param_dict(model: torch.nn.Module) -> dict:
    """The model's parameters by key path (the fp32 masters themselves)."""
    return dict(model.named_parameters())


def init_state(model: af2.AlphaFold2, optimizer: Optimizer, ema: Ema = None,
               *, compress_err: bool = False) -> dict:
    """Train state: ``params`` (the model: its parameters are the fp32
    masters), ``opt`` (an ``OptState`` over them by key path), with an EMA
    ``ema`` (fp32 copies by key path), and with ``compress_err`` (a plan's
    ``compress_pod_grads``) ``err``, the int8 error-feedback residuals
    (``parallel.grad_sync``)."""
    params = param_dict(model)
    state = {"params": model, "opt": optimizer.init(params)}
    if ema is not None:
        state["ema"] = ema.init(params)
    if compress_err:
        from repro_torch.parallel.grad_sync import zeros_error_state
        state["err"] = zeros_error_state(params)
    return state


def build_plan(plan, cfg, device, ranks=None) -> BuiltPlan:
    """``plan`` (a ``ParallelPlan``; None: one device) built on ``device``
    over the global ``ranks`` (None: the whole world).  A plan of several
    ranks creates process groups: every rank of the world calls this
    together, also a rank outside ``ranks``."""
    return as_plan(plan).build(ranks, cfg=cfg, device=device)


def step_inputs(batch: dict, rng, opt_step: int, device,
                built: BuiltPlan = None) -> tuple:
    """The step body's tensor inputs on ``device``: this data-parallel
    replica's rows of the global batch (numpy or torch, leading batch axis;
    ``built`` None: all of it), the dropout key lanes of ``rng`` (an int or
    a tuple of ints, e.g. (seed, step)) and the optimizer's new step count
    as a 0-d fp32 tensor."""
    if built is not None:
        rows = built.local_rows(next(iter(batch.values())).shape[0])
        batch = {k: v[rows] for k, v in batch.items()}
    words = (rng,) if isinstance(rng, int) else tuple(rng)
    return (af2.to_device(batch, device),
            evo.dropout_key(words, device).lanes,
            torch.tensor(float(opt_step), dtype=torch.float32, device=device))


def make_step_body(cfg, optimizer: Optimizer, built: BuiltPlan = None, *,
                   deterministic: bool = True, ema: Ema = None,
                   dtype=torch.bfloat16):
    """Returns ``body(state, batch, key, opt_step, n_recycle) -> metrics``.

    ``batch`` holds this rank's proteins as tensors on the model's device,
    with a leading batch axis (its data-parallel rows); ``key`` the (2,)
    int64 dropout key lanes (protein b draws from ``evo.Key(key, (b,))``,
    and under data parallelism from ``evo.Key(key, (replica, b))``);
    ``opt_step`` a 0-d fp32 tensor holding ``state["opt"].step + 1``;
    ``n_recycle`` a host int, the same on every rank.

    The proteins go through ``loss_fn`` and its backward one after the
    other (the reference scans over them), with the plan's ``block_fn`` and
    ``stack_io``.  Under BP / DAP a rank's gradient is partial: with
    ``optimizer.per_sample_clip`` each protein's gradient is completed over
    the plan's sync axes (``complete_partial_grads``), so that its norm is
    the protein's, and clipped to that global norm (AF2 suppl. 1.11.3)
    before the gradients are averaged; without it the average of the
    partial gradients is completed once, as the reference does (and the
    optimizer's own ``clip_norm``, if any, clips it).  The plan's
    ``grad_sync`` then averages the gradient over the data-parallel axes
    (int8-compressed on the pod hop with ``state["err"]``),
    ``optimizer.apply`` updates the masters and moments in place, then the
    EMA; ``state["opt"].step`` is left to the caller.  Returns the
    :data:`METRICS` as 0-d fp32 tensors, averaged over the global batch:
    the loss and the four terms, the global norm of the applied gradient
    ``grad_norm``, and ``sample_grad_norm``: with the per-sample clip the
    mean global norm of the proteins' gradients before clipping, without
    it the global norm of the replica's completed mean gradient (the same
    when a replica holds one protein).  Every gradient is set to None
    before each protein and at the end, so under a graph capture backward
    allocates them from the graph's pool.
    """
    built = built if built is not None else ParallelPlan().build()
    clip = optimizer.per_sample_clip
    sync = tuple(built.axis(a) for a in built.sync_axes)
    dps = tuple(built.axis(a) for a in built.dp_axes)
    dp_size, dp_rank = built.dp_size, built.dp_rank

    def body(state, batch, key, opt_step, n_recycle: int):
        model = state["params"]
        params = param_dict(model)
        n = batch["target_feat"].shape[0]
        acc = {k: torch.zeros_like(p) for k, p in params.items()}
        sums = {}
        for b in range(n):
            sample = {k: v[b] for k, v in batch.items()}
            for p in params.values():
                p.grad = None
            # decorrelate dropout across data-parallel replicas
            path = (dp_rank, b) if dp_size > 1 else (b,)
            loss, metrics = af2.loss_fn(model, cfg, sample,
                                        n_recycle=n_recycle,
                                        rng=evo.Key(key, path),
                                        deterministic=deterministic,
                                        dtype=dtype, block_fn=built.block_fn,
                                        stack_io=built.stack_io)
            loss.backward()
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in params.items()}
            if clip is not None:
                # a shard's gradient is partial, and its norm is not the
                # protein's: complete it before the norm and the clip
                grads = complete_partial_grads(grads, sync)
                grads, metrics["sample_grad_norm"] = clip_by_global_norm(
                    grads, clip)
            for k, g in grads.items():
                acc[k].add_(g.float())
            for k, v in metrics.items():
                sums[k] = v.detach() if b == 0 else sums[k] + v.detach()
        for p in params.values():
            p.grad = None
        grads = {k: g / n for k, g in acc.items()}
        out = {k: v / n for k, v in sums.items()}
        if clip is None:
            grads = complete_partial_grads(grads, sync)
            out["sample_grad_norm"] = global_norm(grads)
        grads, err = built.grad_sync(grads, state.get("err"), completed=True)
        if err is not None:
            for k, e in err.items():
                state["err"][k].copy_(e)
        out = coll.pmean_tree(out, dps)
        out["grad_norm"] = global_norm(grads)
        optimizer.apply(grads, state["opt"], params, opt_step)
        if ema is not None:
            ema.update(state["ema"], params)
        return tuple(out[k] for k in METRICS)

    return body


def make_af2_train_step(cfg, optimizer: Optimizer, plan=None, *, ranks=None,
                        n_recycle: int = 1, deterministic: bool = True,
                        device=None, ema: Ema = None, dtype=torch.bfloat16):
    """Returns ``train_step(state, batch, rng, n_recycle=None)``: one eager
    step of :func:`make_step_body` under ``plan`` (a ``ParallelPlan``; None:
    one device), built here on ``device`` over the global ``ranks`` (None:
    the whole world) by every rank of the world together.

    ``batch`` holds the global batch's proteins with a leading batch axis
    (``data.protein.protein_batch``), the same on every rank; each
    data-parallel replica takes its rows (:func:`step_inputs`).
    ``rng`` is an int or a tuple of ints (the trainer passes ``(seed,
    step)``): its words make the dropout key.  ``n_recycle`` overrides the
    factory's recycle count for this step (stochastic recycling).  Returns
    ``(state, metrics)``, the :data:`METRICS` as floats, with
    ``state["opt"].step`` advanced.
    """
    device = resolve_device(device)
    built = build_plan(plan, cfg, device, ranks)
    body = make_step_body(cfg, optimizer, built, deterministic=deterministic,
                          ema=ema, dtype=dtype)

    def train_step(state, batch, rng, n_recycle_t=None):
        if next(state["params"].parameters()).device != device:
            raise ValueError(f"model is not on {device}")
        nr = n_recycle if n_recycle_t is None else int(n_recycle_t)
        opt = state["opt"]
        out = body(state, *step_inputs(batch, rng, opt.step + 1, device,
                                       built), nr)
        state["opt"] = opt._replace(step=opt.step + 1)
        return state, {k: float(v) for k, v in zip(METRICS, out)}

    return train_step


# ---------------------------------------------------------------------------
# LM train step (the reference's make_lm_train_step, one device)
# ---------------------------------------------------------------------------

def init_lm_state(model: torch.nn.Module, optimizer: Optimizer) -> dict:
    """LM train state: ``params`` (the model: its parameters are the fp32
    masters) and ``opt`` (an ``OptState`` over them by key path)."""
    return {"params": model, "opt": optimizer.init(param_dict(model))}


def lm_value_and_grad(lm, cfg, model: torch.nn.Module, batch: dict, *,
                      microbatch: int = None):
    """(loss, gradients by key path) of ``lm.loss(model, cfg, batch)``
    (``lm`` the family's module, ``models.get_model(cfg)``).  With
    ``microbatch`` = n > 1 the batch's leading axis is split into n equal
    parts, their losses and fp32 gradients summed and divided by n, as the
    reference's scan over microbatches does."""
    params = param_dict(model)
    keys, leaves = list(params), list(params.values())

    def one(part):
        loss = lm.loss(model, cfg, part)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    if not microbatch or microbatch <= 1:
        loss, grads = one(batch)
    else:
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        for i in range(microbatch):
            part = {k: v.reshape(microbatch, v.shape[0] // microbatch,
                                 *v.shape[1:])[i] for k, v in batch.items()}
            l, g = one(part)
            loss = loss + l
            for acc, gi in zip(grads, g):
                acc.add_(gi.float())
        loss = loss / microbatch
        grads = [g / microbatch for g in grads]
    return loss, dict(zip(keys, grads))


def make_lm_train_step(lm, cfg, optimizer: Optimizer, *,
                       microbatch: int = None):
    """Returns ``train_step(state, batch) -> (state, {"loss": 0-d
    tensor})``: value and gradient of the family's ``loss``
    (:func:`lm_value_and_grad`), then ``optimizer.update``, which writes the
    parameters and moments of ``state`` in place and advances its step.

    One device: the reference's ``constrain`` (sharding constraints at the
    layer boundaries) is the identity here, and its ``state_shardings`` /
    batch sharding have no counterpart until the LM partition rules are
    ported."""
    def train_step(state: dict, batch: dict):
        loss, grads = lm_value_and_grad(lm, cfg, state["params"], batch,
                                        microbatch=microbatch)
        _, state["opt"] = optimizer.update(grads, state["opt"],
                                           param_dict(state["params"]))
        return state, {"loss": loss}

    return train_step
