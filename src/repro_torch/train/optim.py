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


# ---------------------------------------------------------------------------
# Adafactor-like (factored second moment), the dry run's LM optimizer
# ---------------------------------------------------------------------------

def stack_groups(keys, stacked=()) -> dict:
    """{leaf key of the reference's tree: [the port's keys]}: a key under a
    list of ``stacked`` (``layers.<i>.rest``) joins the group
    ``layers.rest`` in block order, as the reference stacks its scanned
    leaves; any other key is a group of its own."""
    groups: dict = {}
    for key in keys:
        head, _, rest = key.partition(".")
        idx, _, name = rest.partition(".")
        if head in stacked and idx.isdigit():
            groups.setdefault(f"{head}.{name}", []).append((int(idx), key))
        else:
            groups[key] = [(None, key)]
    return {g: [k for _, k in sorted(m, key=lambda t: -1 if t[0] is None
                                     else t[0])]
            for g, m in groups.items()}


def stacked_shape(shapes, group_keys, key) -> tuple:
    """The reference's shape of group ``key``: its leaves' shape with the
    block count in front when the group stacks blocks."""
    members = group_keys[key]
    one = tuple(shapes[members[0]])
    return one if members == [key] else (len(members),) + one


def adafactor_like(lr, *, eps: float = 1e-30, clip_norm: Optional[float] = None,
                   per_sample_clip: Optional[float] = None,
                   stacked=()) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern), the reference's
    ``adafactor_like``: for each leaf of the reference's tree a second
    moment factored into row and column means ``(vr, vc)`` where the leaf
    has two dims or more, dense below; a scalar ``mu`` (never updated, as in
    the reference); ``b2 = 1 - step^-0.8``; update clipping at RMS 1.

    ``stacked``: the lists whose per-block leaves the reference scans as one
    stacked leaf (``bridge.LM_STACKED`` under ``cfg.scan_layers``).  Their
    statistics are those of the stacked leaf: the state is keyed by the
    reference's leaf (``stack_groups``), its factors carry the block axis,
    and the update's RMS clip runs over every block of the leaf.  The
    moments of a 2-d-or-more block are per block (the reference's factors
    of a stack keep the block axis); those of a 1-d block span the stack.

    Under a ``parallel.fsdp.Layout`` the statistics are those of this
    rank's slices, not of the whole leaf (the dry run traces the step's
    shapes, not its values)."""
    sched = _schedule(lr)

    def vshape(shape):
        if len(shape) >= 2:
            return (shape[:-1], shape[:-2] + shape[-1:])
        return shape

    def init(params):
        params = dict(_items(params))
        groups = stack_groups(params, stacked)
        shapes = {k: tuple(p.shape) for k, p in params.items()}
        mu, nu = {}, {}
        for g, members in groups.items():
            dev = params[members[0]].device
            zeros = lambda s: torch.zeros(s, dtype=torch.float32, device=dev)
            vs = vshape(stacked_shape(shapes, groups, g))
            nu[g] = (tuple(zeros(s) for s in vs) if isinstance(vs[0], tuple)
                     else zeros(vs))
            mu[g] = zeros(())
        return OptState(step=0, mu=mu, nu=nu)

    def factored_update(g, vr, vc, b2):
        """The reference's factored update direction of one (block of a)
        leaf, updating ``vr`` / ``vc`` in place."""
        g2 = g.square() + eps
        vr.mul_(b2).add_((1 - b2) * g2.mean(-1))
        vc.mul_(b2).add_((1 - b2) * g2.mean(-2))
        denom = (vr[..., None] * vc[..., None, :]
                 / torch.clamp(vr.mean(-1, keepdim=True), min=eps)[..., None])
        return g / torch.sqrt(denom + eps)

    def step_params(grads, state, params, lr_t, b2, grad_norm):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm, grad_norm)
        params = dict(_items(params))
        for gk, members in stack_groups(params, stacked).items():
            v = state.nu[gk]
            gs = [grads[k].float() for k in members]
            if members == [gk] or params[members[0]].dim() == 0 or \
                    params[members[0]].dim() == 1:
                # one leaf, or a stack of vectors / scalars: the stacked
                # leaf itself (small), as the reference computes it
                g = gs[0] if members == [gk] else torch.stack(gs)
                if isinstance(v, tuple):
                    upd = factored_update(g, v[0], v[1], b2)
                else:
                    v.mul_(b2).add_((1 - b2) * (g.square() + eps))
                    upd = g / torch.sqrt(v + eps)
                upds = [upd] if members == [gk] else list(upd.unbind(0))
            else:
                # a stack of matrices: the factors are per block
                upds = [factored_update(g, v[0][i], v[1][i], b2)
                        for i, g in enumerate(gs)]
            n = sum(u.numel() for u in upds)
            rms = torch.sqrt(sum(u.square().sum() for u in upds) / n + eps)
            clip = torch.clamp(rms, min=1.0)
            for k, u in zip(members, upds):
                p = params[k]
                p.copy_(p.float() - lr_t * (u / clip))

    def _b2(step: torch.Tensor) -> torch.Tensor:
        return 1.0 - step ** -0.8

    @torch.no_grad()
    def update(grads, state, params, grad_norm=None):
        step = state.step + 1
        st = torch.tensor(float(step), dtype=torch.float32)
        step_params(grads, state, params, sched(step), float(_b2(st)),
                    grad_norm)
        return params, OptState(step=step, mu=state.mu, nu=state.nu)

    @torch.no_grad()
    def apply(grads, state, params, step: torch.Tensor, grad_norm=None):
        step_params(grads, state, params, _on_device(sched, step),
                    _b2(step.float()), grad_norm)
        return params

    return Optimizer(init=init, update=update, apply=apply,
                     per_sample_clip=per_sample_clip)
