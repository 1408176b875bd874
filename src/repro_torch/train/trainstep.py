"""The AlphaFold2 training step on one device (counterpart of
``repro/train/trainstep.py::make_af2_train_step``, without its
``ParallelPlan``: Branch Parallelism and DAP come with their own slice).

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
from repro_torch.train.optim import (Ema, Optimizer, clip_by_global_norm,
                                    global_norm)

# the step's outputs, in this order
METRICS = ("loss", "fape", "distogram", "masked_msa", "plddt", "grad_norm",
           "sample_grad_norm")


def param_dict(model: torch.nn.Module) -> dict:
    """The model's parameters by key path (the fp32 masters themselves)."""
    return dict(model.named_parameters())


def init_state(model: af2.AlphaFold2, optimizer: Optimizer, ema: Ema = None
               ) -> dict:
    """Train state: ``params`` (the model: its parameters are the fp32
    masters), ``opt`` (an ``OptState`` over them by key path) and, with an
    EMA, ``ema`` (fp32 copies by key path)."""
    params = param_dict(model)
    state = {"params": model, "opt": optimizer.init(params)}
    if ema is not None:
        state["ema"] = ema.init(params)
    return state


def step_inputs(batch: dict, rng, opt_step: int, device) -> tuple:
    """The step body's tensor inputs on ``device``: the batch (numpy or
    torch, leading batch axis), the dropout key lanes of ``rng`` (an int or
    a tuple of ints, e.g. (seed, step)) and the optimizer's new step count
    as a 0-d fp32 tensor."""
    words = (rng,) if isinstance(rng, int) else tuple(rng)
    return (af2.to_device(batch, device),
            evo.dropout_key(words, device).lanes,
            torch.tensor(float(opt_step), dtype=torch.float32, device=device))


def make_step_body(cfg, optimizer: Optimizer, *, deterministic: bool = True,
                   ema: Ema = None, dtype=torch.bfloat16):
    """Returns ``body(state, batch, key, opt_step, n_recycle) -> metrics``.

    ``batch`` holds the proteins' features as tensors on the model's device,
    with a leading batch axis; ``key`` the (2,) int64 dropout key lanes
    (protein b draws from ``evo.Key(key, (b,))``); ``opt_step`` a 0-d fp32
    tensor holding ``state["opt"].step + 1``; ``n_recycle`` a host int.

    The proteins go through ``loss_fn`` and its backward one after the
    other (the reference scans over them).  With
    ``optimizer.per_sample_clip`` each protein's gradient is clipped to that
    global norm before the gradients are averaged (AF2 suppl. 1.11.3);
    otherwise the batch gradient is the plain average (and the optimizer's
    own ``clip_norm``, if any, clips it).  Then ``optimizer.apply`` updates
    the masters and moments in place, then the EMA; ``state["opt"].step``
    is left to the caller.  Returns the :data:`METRICS` as 0-d fp32
    tensors: the loss and the four terms averaged over the batch, the
    global norm of the applied batch gradient ``grad_norm`` and the mean
    global norm of the proteins' gradients before clipping
    ``sample_grad_norm``.  Every gradient is set to None before each
    protein and at the end, so under a graph capture backward allocates
    them from the graph's pool.
    """
    clip = optimizer.per_sample_clip

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
            loss, metrics = af2.loss_fn(model, cfg, sample,
                                        n_recycle=n_recycle,
                                        rng=evo.Key(key, (b,)),
                                        deterministic=deterministic,
                                        dtype=dtype)
            loss.backward()
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in params.items()}
            if clip is not None:
                grads, norm = clip_by_global_norm(grads, clip)
            else:
                norm = global_norm(grads)
            metrics["sample_grad_norm"] = norm
            for k, g in grads.items():
                acc[k].add_(g.float())
            for k, v in metrics.items():
                sums[k] = v.detach() if b == 0 else sums[k] + v.detach()
        for p in params.values():
            p.grad = None
        grads = {k: g / n for k, g in acc.items()}
        out = {k: v / n for k, v in sums.items()}
        out["grad_norm"] = global_norm(grads)
        optimizer.apply(grads, state["opt"], params, opt_step)
        if ema is not None:
            ema.update(state["ema"], params)
        return tuple(out[k] for k in METRICS)

    return body


def make_af2_train_step(cfg, optimizer: Optimizer, *, n_recycle: int = 1,
                        deterministic: bool = True, device=None,
                        ema: Ema = None, dtype=torch.bfloat16):
    """Returns ``train_step(state, batch, rng, n_recycle=None)``: one eager
    step of :func:`make_step_body`.

    ``batch`` holds the proteins' features with a leading batch axis
    (``data.protein.protein_batch``); ``rng`` is an int or a tuple of ints
    (the trainer passes ``(seed, step)``): its words make the dropout key.
    ``n_recycle`` overrides the factory's recycle count for this step
    (stochastic recycling).  Returns ``(state, metrics)``, the
    :data:`METRICS` as floats, with ``state["opt"].step`` advanced.
    """
    device = resolve_device(device)
    body = make_step_body(cfg, optimizer, deterministic=deterministic,
                          ema=ema, dtype=dtype)

    def train_step(state, batch, rng, n_recycle_t=None):
        if next(state["params"].parameters()).device != device:
            raise ValueError(f"model is not on {device}")
        nr = n_recycle if n_recycle_t is None else int(n_recycle_t)
        opt = state["opt"]
        out = body(state, *step_inputs(batch, rng, opt.step + 1, device), nr)
        state["opt"] = opt._replace(step=opt.step + 1)
        return state, {k: float(v) for k, v in zip(METRICS, out)}

    return train_step
