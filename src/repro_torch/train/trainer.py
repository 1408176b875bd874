"""``TrainRunner``: the AlphaFold2 training loop on one device (counterpart
of the core of ``repro/train/trainer.py``).

Defaults as the reference's: AdamW on ``af2_lr_schedule(1e-3,
warmup_steps=100)`` with per-sample clipping at 0.1, EMA 0.999, stochastic
recycling (``n_recycle`` drawn from 1..``max_recycle`` per step,
deterministically in (seed, step)), dropout on.  Every attention and
triangle update runs on the hand-written kernels (their plain versions on
the CPU).  Evaluation, checkpoints, the step watchdog, telemetry and the
data pipeline of the reference are not ported yet.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.config import with_kernels
from repro_torch.core.model import AlphaFold2
from repro_torch.data.protein import protein_batch
from repro_torch.device import resolve_device
from repro_torch.train import optim as optim_lib
from repro_torch.train.trainstep import init_state, make_af2_train_step


class TrainRunner:
    """Drive AF2 training for a config on one device.

    ``ema_decay=None`` keeps no EMA copy; ``recycle_sample=False`` runs the
    fixed ``n_recycle`` every step.  ``device``: ``cuda`` unless ``"cpu"``
    is passed (raises without a card).  ``model``: the AlphaFold2 to train
    (on ``device``), else one initialised from ``seed``.  ``state`` holds ``params`` (the
    model), ``opt`` and ``ema``; ``history`` the per-step ``loss``,
    ``n_recycle`` and ``step_s`` (wall seconds, ending in a synchronize on
    the card).
    """

    def __init__(self, cfg, *, optimizer=None, batch_size: int = 1,
                 seed: int = 0, n_recycle: int = 1, recycle_sample: bool = True,
                 max_recycle: Optional[int] = None,
                 ema_decay: Optional[float] = 0.999,
                 deterministic: bool = False, device=None, model=None):
        self.device = resolve_device(device)
        self.cfg = with_kernels(cfg)
        self.seed = seed
        self.batch_size = batch_size
        self.n_recycle = n_recycle
        self.recycle_sample = recycle_sample
        self.max_recycle = max_recycle or cfg.max_recycle
        self.optimizer = optimizer or optim_lib.adamw(
            optim_lib.af2_lr_schedule(1e-3, warmup_steps=100),
            per_sample_clip=0.1)
        self.ema = optim_lib.ema(ema_decay) if ema_decay else None
        self._train_step = make_af2_train_step(
            self.cfg, self.optimizer, n_recycle=n_recycle,
            deterministic=deterministic, device=self.device, ema=self.ema)
        if model is None:
            model = AlphaFold2(self.cfg, seed=seed, device=self.device)
        self.state = init_state(model, self.optimizer, self.ema)
        self.step = 0
        self.history = {"loss": [], "n_recycle": [], "step_s": []}
        self.last_metrics: dict = {}

    @property
    def model(self) -> AlphaFold2:
        return self.state["params"]

    def recycle_draw(self, step: int) -> int:
        """This step's ``n_recycle``: Uniform{1..max_recycle}, deterministic
        in (seed, step) — the reference's draw, number for number."""
        if not self.recycle_sample:
            return self.n_recycle
        gen = np.random.default_rng([abs(self.seed), step])
        return int(gen.integers(1, self.max_recycle + 1))

    def batch(self, step: int) -> dict:
        return protein_batch(self.seed, step, self.batch_size, self.cfg)

    def run(self, steps: int, *, log_every: int = 0, log=print) -> dict:
        """Train until global step ``steps`` (continuing from ``self.step``);
        returns ``history``."""
        for step in range(self.step, steps):
            batch = self.batch(step)
            nr = self.recycle_draw(step)
            t0 = time.perf_counter()
            self.state, metrics = self._train_step(
                self.state, batch, (self.seed, step),
                nr if self.recycle_sample else None)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.last_metrics = metrics
            self.history["loss"].append(metrics["loss"])
            self.history["n_recycle"].append(nr)
            self.history["step_s"].append(dt)
            self.step = step + 1
            if log_every and step % log_every == 0:
                log(f"step {step:5d}  loss {metrics['loss']:.4f}  n_recycle "
                    f"{nr}  ({self.batch_size / max(dt, 1e-9):.2f} protein/s)")
        return self.history
