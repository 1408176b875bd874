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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

Schedule = Callable[[int], float]


class OptState(NamedTuple):
    step: int
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
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


def _f32(x: float) -> float:
    """``x`` rounded to fp32, as the reference's traced fp32 scalars are."""
    return float(torch.tensor(x, dtype=torch.float32))


# ---------------------------------------------------------------------------
# Schedules: step -> learning rate, computed in fp32 as the reference does
# ---------------------------------------------------------------------------

def warmup_constant(base_lr: float, warmup_steps: int) -> Schedule:
    def fn(step):
        s = torch.tensor(step, dtype=torch.float32)
        return float(base_lr * torch.clamp((s + 1) / max(warmup_steps, 1),
                                           max=1.0))
    return fn


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Schedule:
    def fn(step):
        s = torch.tensor(step, dtype=torch.float32)
        warm = torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return float(base_lr * warm * cos)
    return fn


def af2_lr_schedule(base_lr: float = 1e-3, warmup_steps: int = 1000,
                    decay_after: int = 50000, decay: float = 0.95) -> Schedule:
    """AF2 suppl. 1.11.3: linear warmup, x0.95 after 50k steps."""
    def fn(step):
        s = torch.tensor(step, dtype=torch.float32)
        warm = torch.clamp((s + 1) / warmup_steps, max=1.0)
        dec = decay if step >= decay_after else 1.0
        return float(base_lr * warm * dec)
    return fn


# ---------------------------------------------------------------------------
# Clipping
# ---------------------------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    """fp32 L2 norm over every tensor of ``tree`` (a 0-d tensor)."""
    return torch.sqrt(sum(x.float().square().sum() for _, x in _items(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to global norm <= ``max_norm``, the norm before)."""
    norm = global_norm(grads)
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

def _schedule(lr) -> Schedule:
    return lr if callable(lr) else (lambda step: float(lr))


def adamw(lr, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, clip_norm: Optional[float] = None,
          per_sample_clip: Optional[float] = None) -> Optimizer:
    sched = _schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return OptState(step=0, mu=_map(zeros, params), nu=_map(zeros, params))

    @torch.no_grad()
    def update(grads, state, params):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        lr_t = sched(step)
        st = torch.tensor(float(step), dtype=torch.float32)
        c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** st)
        c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** st)
        for k, p in _items(params):
            m, v, g = state.mu[k], state.nu[k], grads[k].float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            delta = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.float()
            p.copy_(p.float() - lr_t * delta)
        return params, OptState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init=init, update=update, per_sample_clip=per_sample_clip)


def sgd(lr, *, momentum: float = 0.0, clip_norm: Optional[float] = None,
        per_sample_clip: Optional[float] = None) -> Optimizer:
    sched = _schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        # nu stays zeros (unused); its own tensors, as mu is updated in place
        return OptState(step=0, mu=_map(zeros, params), nu=_map(zeros, params))

    @torch.no_grad()
    def update(grads, state, params):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        lr_t = sched(step)
        for k, p in _items(params):
            m = state.mu[k]
            m.mul_(momentum).add_(grads[k].float())
            p.copy_(p.float() - lr_t * m)
        return params, OptState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init=init, update=update, per_sample_clip=per_sample_clip)
