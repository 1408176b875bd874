"""The AlphaFold2 training step on one device (counterpart of
``repro/train/trainstep.py::make_af2_train_step``, without its
``ParallelPlan``: Branch Parallelism and DAP come with their own slice).
"""
from __future__ import annotations

import torch

from repro_torch.core import model as af2
from repro_torch.device import resolve_device
from repro_torch.train.optim import (Ema, Optimizer, clip_by_global_norm,
                                    global_norm)


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


def make_af2_train_step(cfg, optimizer: Optimizer, *, n_recycle: int = 1,
                        deterministic: bool = True, device=None,
                        ema: Ema = None, dtype=torch.bfloat16):
    """Returns ``train_step(state, batch, rng, n_recycle=None)``.

    ``batch`` holds the proteins' features with a leading batch axis
    (``data.protein.protein_batch``); ``rng`` is an int or a tuple of ints
    (the trainer passes ``(seed, step)``) and protein b of the batch draws
    its dropout from ``rng + (b,)``.  ``n_recycle`` overrides the factory's
    recycle count for this step (stochastic recycling).

    The proteins go through ``loss_fn`` and its backward one after the
    other (the reference scans over them).  With
    ``optimizer.per_sample_clip`` each protein's gradient is clipped to that
    global norm before the gradients are averaged (AF2 suppl. 1.11.3);
    otherwise the batch gradient is the plain average (and the optimizer's
    own ``clip_norm``, if any, clips it).  Then the optimizer updates the
    masters in place, then the EMA.  Returns ``(state, metrics)``: the loss
    and the four terms averaged over the batch, as floats, plus the global
    norm of the applied batch gradient ``grad_norm`` and the mean global
    norm of the proteins' gradients before clipping ``sample_grad_norm``.
    """
    device = resolve_device(device)
    clip = optimizer.per_sample_clip

    def train_step(state, batch, rng, n_recycle_t=None):
        model = state["params"]
        if next(model.parameters()).device != device:
            raise ValueError(f"model is not on {device}")
        nr = n_recycle if n_recycle_t is None else int(n_recycle_t)
        base = (rng,) if isinstance(rng, int) else tuple(rng)
        params = param_dict(model)
        n = len(batch["target_feat"])
        acc = {k: torch.zeros_like(p) for k, p in params.items()}
        sums = {}
        for b in range(n):
            sample = {k: v[b] for k, v in batch.items()}
            for p in params.values():
                p.grad = None
            loss, metrics = af2.loss_fn(model, cfg, sample, n_recycle=nr,
                                        rng=(*base, b),
                                        deterministic=deterministic,
                                        dtype=dtype)
            loss.backward()
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in params.items()}
            if clip is not None:
                grads, norm = clip_by_global_norm(grads, clip)
            else:
                norm = global_norm(grads)
            sums["sample_grad_norm"] = sums.get("sample_grad_norm", 0.0) + norm
            for k, g in grads.items():
                acc[k].add_(g.float())
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
        for p in params.values():
            p.grad = None
        grads = {k: g / n for k, g in acc.items()}
        gnorm = float(global_norm(grads))
        _, state["opt"] = optimizer.update(grads, state["opt"], params)
        if ema is not None:
            ema.update(state["ema"], params)
        out = {k: float(v) / n for k, v in sums.items()}
        out["grad_norm"] = gnorm
        return state, out

    return train_step
