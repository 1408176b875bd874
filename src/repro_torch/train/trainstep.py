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

The LM zoo's step (:func:`make_lm_train_step`, the reference's
``make_lm_train_step``) runs on one device, or over a ("data", "model")
mesh: data-parallel over ``data`` with each leaf sharded as the family's
partition rules say under ``cfg.fsdp`` (``parallel.fsdp``), and
tensor-parallel over ``model`` (``parallel.tensor``); the reference's
sharding helpers (``sanitize_spec``, ``shardings_for``,
``state_shardings``) give the spec each rank holds its slice by.
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch import bridge
from repro_torch.core import evoformer as evo
from repro_torch.core import model as af2
from repro_torch.device import resolve_device
from repro_torch.nn.partition import P, make_param_specs
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import fsdp
from repro_torch.parallel import tensor
from repro_torch.parallel.mesh_utils import Axis, merged_axis, mesh_shape
from repro_torch.parallel.plan import (BuiltPlan, ParallelPlan, as_plan,
                                       complete_partial_grads)
from repro_torch.train.optim import (Ema, Optimizer, OptState,
                                    clip_by_global_norm, global_norm,
                                    stack_groups, stacked_shape)

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
# LM sharding helpers (the reference's trainstep.py:27-145)
# ---------------------------------------------------------------------------

def _extents(mesh) -> dict:
    """{axis: extent} of a ``DeviceMesh`` (``mesh_utils.mesh_shape``) or of
    a mapping of them."""
    return dict(mesh) if isinstance(mesh, Mapping) else mesh_shape(mesh)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def sanitize_spec(spec, shape, mesh) -> P:
    """Drop mesh axes from dims they do not divide (e.g. batch=1 decode):
    the spec over every dim of ``shape``, each entry the axes (in order)
    whose running product of extents divides that dim."""
    ext = _extents(mesh)
    out = []
    for i, names in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if names is None:
            out.append(None)
            continue
        names_t = names if isinstance(names, tuple) else (names,)
        total, keep = 1, []
        for n in names_t:
            if shape[i] % (total * ext[n]) == 0:
                keep.append(n)
                total *= ext[n]
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep
                                                      else None))
    return P(*out)


def sanitize_spec_tree(shapes: Mapping, specs: Mapping, mesh) -> dict:
    """{key: sanitized spec} for {key: shape or tensor} and {key: spec}."""
    return {k: sanitize_spec(specs[k], _shape(v), mesh)
            for k, v in shapes.items()}


def shardings_for(shapes: Mapping, rules, mesh, *, stacked=()) -> dict:
    """{key: shape or tensor} + rules -> {key: sanitized spec}: the spec by
    which each rank holds its slice of the leaf (the reference's
    ``NamedSharding``).  ``stacked``: as ``make_param_specs``."""
    specs = make_param_specs({k: _shape(v) for k, v in shapes.items()},
                             rules, stacked=stacked)
    return sanitize_spec_tree(shapes, specs, mesh)


def lm_stacked(cfg) -> tuple:
    """The lists whose leaves' rules carry the stacked layer axis:
    ``bridge.LM_STACKED`` under ``cfg.scan_layers``, else none."""
    return bridge.LM_STACKED if cfg.scan_layers else ()


def state_shardings(lm, cfg, mesh, params_shapes: Mapping,
                    opt_shapes: OptState = None) -> dict:
    """The reference's ``state_shardings``: {"params": {key: spec}, "opt":
    OptState(step=P(), mu=..., nu=...)}, every spec sanitized over
    ``mesh``'s extents; ``opt_shapes`` (an ``OptState`` of tensors or
    shapes) fits each moment's spec to its shape
    (:func:`_opt_branch_shardings`), else the moments take the params'.
    Moments keyed by the reference's stacked leaves (``adafactor_like``
    with ``stacked``) are fitted to the stacked leaf's shape and spec."""
    rules = lm.partition_rules(cfg)
    specs = shardings_for(params_shapes, rules, mesh, stacked=lm_stacked(cfg))
    if opt_shapes is None:
        return {"params": specs, "opt": OptState(step=P(), mu=specs,
                                                 nu=specs)}
    shapes, pspecs = params_shapes, specs
    if any(k not in params_shapes for k in opt_shapes.nu):
        groups = stack_groups(params_shapes, lm_stacked(cfg))
        shapes = {g: stacked_shape({k: _shape(v) for k, v in
                                    params_shapes.items()}, groups, g)
                  for g in groups}
        pspecs = shardings_for(shapes, rules, mesh)
    fit = lambda branch: _opt_branch_shardings(shapes, pspecs, branch)
    return {"params": specs, "opt": OptState(step=P(), mu=fit(opt_shapes.mu),
                                             nu=fit(opt_shapes.nu))}


def _opt_branch_shardings(params_shapes: Mapping, pspecs: Mapping,
                          branch: Mapping) -> dict:
    """Specs for one optimizer-state branch whose leaves mirror params but
    may be lower-rank (a factored second moment: a (row, col) tuple) or
    scalars: the param's spec fitted to each leaf's shape."""
    def fit(pshape, spec, leaf):
        sp = tuple(spec) + (None,) * (len(pshape) - len(spec))

        def one(x):
            shape = _shape(x)
            if shape == tuple(pshape):
                return P(*sp)
            if len(shape) == 0:
                return P()
            if shape == tuple(pshape[:-1]):                  # row factor
                return P(*sp[:-1])
            if shape == tuple(pshape[:-2]) + (pshape[-1],):  # col factor
                return P(*sp[:-2], sp[-1])
            return P()
        if isinstance(leaf, (tuple, list)) and not isinstance(leaf, P) \
                and leaf and hasattr(leaf[0], "shape"):
            return tuple(one(x) for x in leaf)
        return one(leaf)
    return {k: fit(_shape(params_shapes[k]), pspecs[k], b)
            for k, b in branch.items()}


# ---------------------------------------------------------------------------
# LM train step (the reference's make_lm_train_step)
# ---------------------------------------------------------------------------

def lm_shapes(lm, cfg) -> dict:
    """{key: full shape} of the family's parameters (drawn on ``meta``:
    nothing is allocated)."""
    model = lm.init_params(cfg, device="meta")
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def lm_layout(lm, cfg, model, mesh, data_axes=("data",)) -> fsdp.Layout:
    """The layout of the leaves of ``model`` (a module of full leaves, or
    {key: full shape}: :func:`lm_shapes`) over ``mesh``: each leaf split
    over 'data' along the dim its sanitized spec names it (``cfg.fsdp``),
    and over 'model' (tensor parallelism) along the dim its spec
    names that, else replicated.  ``data_axes``: the batch's axes, 'data'
    last ("pod" before it replicates every leaf); another axis of the mesh
    wider than 1 raises."""
    if data_axes[-1] != "data":
        raise NotImplementedError(f"the batch's axes end in 'data' (the "
                                  f"partition rules' FSDP axis), got "
                                  f"{data_axes}")
    wide = {a: e for a, e in mesh_shape(mesh).items()
            if a not in data_axes + ("model",) and e > 1}
    if wide:
        raise NotImplementedError(
            f"the LM step splits over {data_axes} and 'model', "
            f"not over {wide}")
    shapes = (dict(model) if isinstance(model, Mapping) else
              {k: tuple(p.shape) for k, p in model.named_parameters()})
    specs = state_shardings(lm, cfg, mesh, shapes)["params"]
    return fsdp.Layout(specs, shapes, Axis(mesh, "data"),
                       model=Axis(mesh, "model"))


def init_lm_state(model: torch.nn.Module, optimizer: Optimizer, *,
                  layout: fsdp.Layout = None) -> dict:
    """LM train state: ``params`` (the model: its parameters are the fp32
    masters) and ``opt`` (an ``OptState`` over them by key path).  With a
    ``layout`` (:func:`lm_layout`) the model is cut to this rank's slices
    in place first (where it is not yet), the moments are made at the
    slices' shapes, and the state keeps the layout."""
    if layout is None:
        return {"params": model, "opt": optimizer.init(param_dict(model))}
    layout.shard_(model)
    return {"params": model, "opt": optimizer.init(param_dict(model)),
            "layout": layout}


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


def data_rows(n: int, size: int, index: int, microbatch: int = 1) -> list:
    """The rows of a global batch of ``n`` that the data rank at ``index``
    of ``size`` takes, one slice per microbatch: microbatch i is the global
    rows [i n/m, (i+1) n/m), as the reference's scan splits them, and the
    rank holds its 1/size of them."""
    if n % (size * microbatch):
        raise ValueError(f"a global batch of {n} does not split into "
                         f"{microbatch} microbatch(es) over {size} data "
                         "ranks")
    per_mb = n // microbatch
    k = per_mb // size
    return [slice(i * per_mb + index * k, i * per_mb + (index + 1) * k)
            for i in range(microbatch)]


def _tokens(part: dict) -> torch.Tensor:
    """The weight of a rank's loss in the global mean: the tokens its
    cross entropy averages over (the mask's sum, or every label)."""
    if "mask" in part:
        return part["mask"].float().sum()
    labels = part["labels"]
    return torch.tensor(float(labels.numel()), device=labels.device)


def make_lm_train_step(lm, cfg, optimizer: Optimizer, mesh=None, *,
                       data_axes=("data",), microbatch: int = None):
    """Returns ``train_step(state, batch) -> (state, {"loss", "grad_norm"}
    as 0-d tensors)``: value and gradient of the family's ``loss``, then
    ``optimizer.update`` (its ``clip_norm`` on the global norm, which
    ``grad_norm`` reports before the clip), which writes the parameters
    and moments of ``state`` in place and advances its step.

    ``mesh=None``: one device (:func:`lm_value_and_grad`); the reference's
    ``constrain`` at the layer boundaries is the identity.

    With a ``mesh`` (the reference's ``(N, M)`` mesh over ("data",
    "model"); ``state`` from :func:`init_lm_state` with the
    :func:`lm_layout` over it), the step is tensor-parallel over ``model``
    (``parallel.tensor``: each rank holds its slices for good, and the
    families' forward runs the collectives; the loss is the same on every
    rank of the axis, and so is each replicated leaf's gradient, so
    nothing is summed over ``model``), and data-parallel, fully sharded
    where the layout says: ``batch`` is the global batch, the same
    on every rank, and each data rank takes its rows (:func:`data_rows`;
    with ``microbatch`` m it runs its rows of each microbatch in turn).
    The forward reads ``parallel.fsdp.Layout.view`` of the state's slices,
    gathering each layer's leaves just before the layer, and the backward
    reduce-scatters their gradients.  The reference's activation
    ``constrain`` is again the identity: each rank already holds its rows.
    Each rank's loss is weighted by its share of the global batch's tokens
    (the mask's, where the batch has one), so the loss is the global
    batch's mean and the reduce-scattered gradient its gradient; a
    replicated leaf's gradient is summed over the axis.  The clip's global
    norm counts each replicated element once (``Layout.global_norm``), and
    the optimizer updates each rank's slices of the parameters and
    moments."""
    if mesh is None:
        def train_step(state: dict, batch: dict):
            loss, grads = lm_value_and_grad(lm, cfg, state["params"], batch,
                                            microbatch=microbatch)
            norm = global_norm(grads)
            _, state["opt"] = optimizer.update(
                grads, state["opt"], param_dict(state["params"]),
                grad_norm=norm)
            return state, {"loss": loss, "grad_norm": norm}
        return train_step

    micro = microbatch if microbatch and microbatch > 1 else 1
    # the batch's rows, the loss and the MoE routing span every data axis;
    # the layout shards over 'data' alone, the others ('pod') replicate
    axis = merged_axis(mesh, data_axes)
    replicas = [Axis(mesh, a) for a in data_axes if a != "data"]
    model_axis = Axis(mesh, "model")

    def train_step(state: dict, batch: dict):
        layout = state.get("layout")
        if layout is None or layout.axis.name != "data":
            raise ValueError("the state has no layout over the data axis "
                             "'data': make it by init_lm_state(model, "
                             "optimizer, layout=lm_layout(...))")
        model = state["params"]
        params = param_dict(model)
        keys, leaves = list(params), list(params.values())
        n = next(iter(batch.values())).shape[0]
        parts = [{k: v[rows] for k, v in batch.items()}
                 for rows in data_rows(n, axis.size, axis.index, micro)]
        counts = torch.stack([_tokens(p) for p in parts])
        weights = counts / torch.clamp(coll.psum(counts, axis), min=1.0)
        dtype = lm.BF16.compute_dtype
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        for part, w in zip(parts, weights):
            # the backward's remat recompute runs the forward again: the
            # same axes for it
            with fsdp.data_parallel(axis), tensor.model_parallel(model_axis):
                obj = lm.loss(layout.view(model, dtype), cfg, part) * w
                grads = torch.autograd.grad(obj, leaves, allow_unused=True)
            loss = loss + obj.detach()
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g.float())
        loss = coll.psum(loss, axis) / micro
        grads = {k: a / micro for k, a in zip(keys, acc)}
        grads.update(coll.psum_tree(
            {k: grads[k] for k in keys if layout.dims[k] is None}, [axis]))
        grads.update(coll.psum_tree(
            {k: grads[k] for k in keys if layout.dims[k] is not None},
            replicas))
        norm = layout.global_norm(grads)
        _, state["opt"] = optimizer.update(grads, state["opt"], params,
                                           grad_norm=norm)
        return state, {"loss": loss, "grad_norm": norm}

    return train_step


def lm_full_state(state: dict) -> dict:
    """``state`` with every leaf of the parameters and moments whole: under
    a layout each sharded leaf gathered (every rank of the mesh calls this
    together) and copied to the host one leaf at a time; without one,
    ``{"params": the parameters by key, "opt": the OptState}``.  The
    checkpoint's tree is ``checkpoint.train_state_tree`` of it."""
    params, opt = param_dict(state["params"]), state["opt"]
    layout = state.get("layout")
    if layout is None:
        return {"params": params, "opt": opt}
    full = lambda tree: {k: layout.full(k, t).cpu() for k, t in tree.items()}
    return {"params": full(params),
            "opt": OptState(step=opt.step, mu=full(opt.mu), nu=full(opt.nu))}


def lm_full_state_like(state: dict) -> dict:
    """A host tree shaped as :func:`lm_full_state`'s, of zeros: what a
    checkpoint of the full arrays restores into."""
    layout, opt = state["layout"], state["opt"]
    zeros = lambda tree: {k: torch.zeros(layout.shapes[k], dtype=t.dtype)
                          for k, t in tree.items()}
    return {"params": zeros(param_dict(state["params"])),
            "opt": OptState(step=opt.step, mu=zeros(opt.mu),
                            nu=zeros(opt.nu))}


@torch.no_grad()
def load_lm_full_state_(state: dict, full: dict) -> dict:
    """Copy this rank's slices of ``full`` (:func:`lm_full_state_like`,
    restored) into ``state``'s parameters and moments in place, and take its
    optimizer step."""
    layout = state["layout"]
    opt = state["opt"]
    pairs = ((param_dict(state["params"]), full["params"]),
             (opt.mu, full["opt"].mu), (opt.nu, full["opt"].nu))
    for live, whole in pairs:
        for k, t in live.items():
            t.copy_(layout.local(k, whole[k]))
    state["opt"] = opt._replace(step=int(full["opt"].step))
    return state
