"""Optimizers, learning-rate schedules, gradient clipping and the EMA of the
parameters (counterpart of ``repro/train/optim.py``).

The API mirrors the reference's: ``opt.init(params) -> OptState`` and
``opt.update(grads, state, params) -> (params, state)``, on dicts (or lists)
of fp32 tensors; the state, the gradients and the EMA are looked up by the
parameters' keys (indices for lists).  Unlike the reference, whose arrays are immutable, the
update writes the new values into ``params`` and the state's tensors in
place (``torch.no_grad``), which keeps one copy of 93M parameters and their
moments on the card; it returns the same objects.  All optimizer state is
fp32 (AMP master copies).

``update`` computes the learning rate and AdamW's bias corrections on the
host from ``state.step``.  ``opt.apply(grads, state, params, step)`` is the
same update with those scalars computed on the device from ``step``, a 0-d
fp32 tensor holding ``state.step + 1``: a captured training step reads it
from a static buffer, so its replays follow the schedule.  Both take
``grad_norm``, the gradient's global norm where the caller has it (the
clip of ``clip_norm`` then uses it: a sharded gradient's norm is not the
norm of this rank's slices).  Both paths do
the same fp32 operations in the same order; ``apply`` leaves
``state.step`` (a Python int) to the caller.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

class OptState(NamedTuple):
    step: int
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    # the update on device scalars (see the module docstring)
    apply: Callable
    # per-SAMPLE gradient clip threshold (AF2 suppl. 1.11.3): read by the
    # train step, which clips each protein's gradient before accumulating;
    # ``clip_norm`` of adamw/sgd clips the accumulated batch gradient instead
    per_sample_clip: Optional[float] = None


def _items(tree):
    return list(tree.items()) if isinstance(tree, dict) else list(enumerate(tree))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return [fn(v) for v in tree]


# ---------------------------------------------------------------------------
# Schedules: step -> learning rate, computed in fp32 as the reference does
# ---------------------------------------------------------------------------

class Schedule:
    """step -> learning rate.  Called with an int step it returns a Python
    float; ``on_device(step)`` takes the step as a 0-d fp32 tensor and
    returns a 0-d fp32 tensor on its device.  Both run ``fn`` (fp32 tensor
    ops on the step) and give the same bits."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        self.fn = fn

    def __call__(self, step: int) -> float:
        return float(self.fn(torch.tensor(step, dtype=torch.float32)))

    def on_device(self, step: torch.Tensor) -> torch.Tensor:
        return self.fn(step.float())


def warmup_constant(base_lr: float, warmup_steps: int) -> Schedule:
    return Schedule(lambda s: base_lr * torch.clamp(
        (s + 1) / max(warmup_steps, 1), max=1.0))


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Schedule:
    def fn(s):
        warm = torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * warm * cos
    return Schedule(fn)


def af2_lr_schedule(base_lr: float = 1e-3, warmup_steps: int = 1000,
                    decay_after: int = 50000, decay: float = 0.95) -> Schedule:
    """AF2 suppl. 1.11.3: linear warmup, x0.95 after 50k steps."""
    def fn(s):
        warm = torch.clamp((s + 1) / warmup_steps, max=1.0)
        return base_lr * warm * torch.where(s >= decay_after, decay, 1.0)
    return Schedule(fn)


# ---------------------------------------------------------------------------
# Clipping
# ---------------------------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    """fp32 L2 norm over every tensor of ``tree`` (a 0-d tensor)."""
    return torch.sqrt(sum(x.float().square().sum() for _, x in _items(tree)))


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """(grads scaled to global norm <= ``max_norm``, the norm before).
    ``norm``: the global norm, when the caller has it (a sharded gradient's
    norm is not its slices' norm: ``parallel.fsdp.Layout.global_norm``)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return _map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# EMA of the parameters (eval-time weights; AF2 suppl. 1.11.7: decay 0.999)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Ema:
    """Exponential moving average of the parameters, kept beside them and
    used for evaluation only; fp32 whatever the parameters' dtype."""
    decay: float = 0.999

    def init(self, params):
        return _map(lambda p: p.detach().float().clone(), params)

    @torch.no_grad()
    def update(self, ema_params, params):
        """In place: e <- d * e + (1 - d) * p."""
        d = self.decay
        for k, p in _items(params):
            ema_params[k].mul_(d).add_((1.0 - d) * p.float())
        return ema_params


def ema(decay: float = 0.999) -> Ema:
    if not 0.0 < decay < 1.0:
        raise ValueError(f"ema decay must be in (0, 1), got {decay}")
    return Ema(decay)


# ---------------------------------------------------------------------------
# AdamW (AF2 trains with Adam; weight decay off by default) and SGD
# ---------------------------------------------------------------------------

def _schedule(lr):
    if callable(lr):
        return lr
    return Schedule(lambda s: torch.full_like(s, lr))


def _on_device(sched, step: torch.Tensor) -> torch.Tensor:
    if not isinstance(sched, Schedule):
        raise ValueError("the device update needs a Schedule of this module "
                         f"or a number as its learning rate, got {sched!r}")
    return sched.on_device(step)


def _bias_correction(beta: float, step: torch.Tensor) -> torch.Tensor:
    """1 - beta ** step in fp32, ``step`` a 0-d fp32 tensor."""
    return 1.0 - torch.full_like(step, beta) ** step


def adamw(lr, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, clip_norm: Optional[float] = None,
          per_sample_clip: Optional[float] = None) -> Optimizer:
    sched = _schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return OptState(step=0, mu=_map(zeros, params), nu=_map(zeros, params))

    def step_params(grads, state, params, lr_t, c1, c2, grad_norm):
        """The moments and parameters in place; ``lr_t``, ``c1``, ``c2``
        Python floats or 0-d fp32 tensors of the same values."""
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm, grad_norm)
        for k, p in _items(params):
            m, v, g = state.mu[k], state.nu[k], grads[k].float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            delta = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.float()
            p.copy_(p.float() - lr_t * delta)

    @torch.no_grad()
    def update(grads, state, params, grad_norm=None):
        step = state.step + 1
        st = torch.tensor(float(step), dtype=torch.float32)
        step_params(grads, state, params, sched(step),
                    float(_bias_correction(b1, st)),
                    float(_bias_correction(b2, st)), grad_norm)
        return params, OptState(step=step, mu=state.mu, nu=state.nu)

    @torch.no_grad()
    def apply(grads, state, params, step: torch.Tensor, grad_norm=None):
        step_params(grads, state, params, _on_device(sched, step),
                    _bias_correction(b1, step), _bias_correction(b2, step),
                    grad_norm)
        return params

    return Optimizer(init=init, update=update, apply=apply,
                     per_sample_clip=per_sample_clip)


def sgd(lr, *, momentum: float = 0.0, clip_norm: Optional[float] = None,
        per_sample_clip: Optional[float] = None) -> Optimizer:
    sched = _schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        # nu stays zeros (unused); its own tensors, as mu is updated in place
        return OptState(step=0, mu=_map(zeros, params), nu=_map(zeros, params))

    def step_params(grads, state, params, lr_t, grad_norm):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm, grad_norm)
        for k, p in _items(params):
            m = state.mu[k]
            m.mul_(momentum).add_(grads[k].float())
            p.copy_(p.float() - lr_t * m)

    @torch.no_grad()
    def update(grads, state, params, grad_norm=None):
        step = state.step + 1
        step_params(grads, state, params, sched(step), grad_norm)
        return params, OptState(step=step, mu=state.mu, nu=state.nu)

    @torch.no_grad()
    def apply(grads, state, params, step: torch.Tensor, grad_norm=None):
        step_params(grads, state, params, _on_device(sched, step), grad_norm)
        return params

    return Optimizer(init=init, update=update, apply=apply,
                     per_sample_clip=per_sample_clip)
