"""``TrainRunner``: the AlphaFold2 training loop (counterpart of the core of
``repro/train/trainer.py``), on one device or on this rank's share of a
``ParallelPlan`` over rank processes.

Defaults as the reference's: AdamW on ``af2_lr_schedule(1e-3,
warmup_steps=100)`` with per-sample clipping at 0.1, EMA 0.999, stochastic
recycling (``n_recycle`` drawn from 1..``max_recycle`` per step,
deterministically in (seed, step)), dropout on.  Every attention and
triangle update runs on the hand-written kernels (their plain versions on
the CPU).

The reference compiles one step for every draw (``n_recycle`` is a traced
loop bound).  On the card the port captures the whole step (forward,
backward, clipping, AdamW, EMA) as a CUDA graph, one per drawn
``n_recycle``, and replays it with each step's batch, dropout key and
optimizer step copied into its static inputs.  Evaluation (lDDT-Cα of the
EMA parameters on the held-out split) goes through a ``FoldEngine``, graphed
too.

Batches come from ``data.pipeline.DataPipeline``: ``data_source=None`` keeps
the synthetic ``protein_batch`` stream; a ``data.ingest`` source switches to
record featurization (optionally length-bucketed), padded onto the
config's one training bucket, so one graph per draw serves every batch.
Host workers featurize the next batches while the step runs, and on the
card each batch is copied to the device one step ahead, on a copy stream.
``ckpt_dir`` turns on checkpoints in the reference's format
(``train.checkpoint``): every ``ckpt_every`` steps and at the end of
``run``; :meth:`TrainRunner.restore` copies a checkpoint into the live
tensors, which the captured graphs go on reading.  A ``StepWatchdog``
flags steps slower than twice its EMA of step walls.

Telemetry as the reference's (``obs``): every metric goes through a
``MetricRegistry`` (``history`` is six live views of its series), each step
runs inside a ``step`` span that ends once the card has finished it, as do
``eval`` and ``checkpoint`` spans, each evaluation records an attribution
row (measured step against ``predict_step_time``), and a ``ProfileWindow``
can capture a step range with ``torch.profiler``.

``hlo_check=True`` (the reference's name): before the first step, the
ungraphed step body runs once under an op trace on a copy of the state
(``analysis.overlap.check_async_overlap``), and its verdict on the async
collectives is recorded as ``train/async_overlap_ok``.

Under a plan (``plan=``, built by every rank together): the plan's
implementation choices are applied to the config, every rank builds the
same global batch from the seed and takes its data-parallel rows, every
rank draws the same ``n_recycle``, the gradients are completed and reduced
by the plan, ``state["err"]`` carries the int8 error feedback of
``compress_pod_grads``, evaluation runs under ``plan.for_inference()``,
and only the mesh's first rank writes checkpoints (every rank restores).  CUDA
graphs cannot capture gloo collectives: under a gloo plan of several ranks
``graphs=True`` raises and ``graphs=None`` means off.
"""
from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import graphs as graphs_lib
from repro_torch.core import heads as heads_lib
from repro_torch.core.config import with_kernels
from repro_torch.core.model import AlphaFold2, to_device
from repro_torch.data.bucketing import train_bucket
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.protein import protein_batch
from repro_torch.device import resolve_device
from repro_torch.obs import (MetricRegistry, attribution_report,
                             describe_attribution, get_tracer, trace_span)
from repro_torch.parallel.plan import as_plan
from repro_torch.serve import fold_steps as fs
from repro_torch.serve.fold_engine import FoldEngine
from repro_torch.train import optim as optim_lib
from repro_torch.train.checkpoint import (CheckpointManager, StepWatchdog,
                                          train_state_tree)
from repro_torch.train.trainstep import (METRICS, build_plan, init_state,
                                         make_step_body, step_inputs)


class TrainRunner:
    """Drive AF2 training for a config on one device, or on this rank's
    share of ``plan`` (a ``ParallelPlan``; None: one device), built here
    over the global ``ranks`` (None: the whole world) by every rank of the
    world together.

    ``ema_decay=None`` keeps no EMA copy (evaluation then uses the raw
    parameters); ``recycle_sample=False`` runs the fixed ``n_recycle`` every
    step.  ``device``: ``cuda`` unless ``"cpu"`` is passed (raises without a
    card).  ``model``: the AlphaFold2 to train (on ``device``), else one
    initialised from ``seed``.  ``dtype``: the compute dtype of training and
    evaluation (the fp32 masters are cast to it).  ``graphs``: replay each
    step from a CUDA graph captured at the first step of its draw (all
    draws in one memory pool); None means on for a CUDA device and off on
    the CPU, True on the CPU raises ValueError.  ``eval_every``: evaluate
    every that many steps (0: only when :meth:`evaluate` is called), over
    ``eval_batches`` held-out batches of ``eval_batch_size`` proteins with
    ``eval_n_recycle`` cycles (default ``max_recycle``).

    Data: ``data_source`` (None: the synthetic stream; else a
    ``data.ingest`` source), ``data_workers`` featurize threads,
    ``data_prefetch`` batches ahead, ``bucket_by_length`` (record sources
    only).  Checkpoints: ``ckpt_dir`` ("" for none), every ``ckpt_every``
    steps, the newest ``keep`` kept, ``install_sigterm`` for a final save
    on SIGTERM.  ``on_straggler(step, dt, ema)`` is called for a step the
    watchdog flags.

    Telemetry: ``obs`` (a ``MetricRegistry``; None: one without sinks),
    ``tracer`` (a ``SpanTracer``; None: the process's, if any) and
    ``profile_window`` (an ``obs.ProfileWindow``).

    ``state`` holds ``params`` (the model), ``opt`` and ``ema``;
    ``history[k] is obs.series(f"train/{k}")``: the per-step ``loss``,
    ``n_recycle`` and ``step_s`` (the watchdog's EMA of step walls, as the
    reference records; each step's own wall is its ``step`` span), the
    ``eval`` rows ({"step", "lddt_ca"}), the ``data`` rows (the pipeline's
    ``StageReport.as_dict()`` and the step, at each evaluation and at the
    end of ``run``) and the ``attribution`` rows (one at each evaluation);
    ``last_metrics`` the last step's ``trainstep.METRICS`` as floats.
    """

    def __init__(self, cfg, plan=None, *, ranks=None, optimizer=None,
                 batch_size: int = 1,
                 seed: int = 0, n_recycle: int = 1, recycle_sample: bool = True,
                 max_recycle: Optional[int] = None,
                 ema_decay: Optional[float] = 0.999,
                 eval_every: int = 0, eval_batches: int = 1,
                 eval_batch_size: int = 2, eval_n_recycle: Optional[int] = None,
                 ckpt_dir: str = "", ckpt_every: int = 50, keep: int = 3,
                 install_sigterm: bool = False,
                 deterministic: bool = False, device=None, model=None,
                 graphs: Optional[bool] = None, dtype=torch.bfloat16,
                 on_straggler=None, data_source=None, data_workers: int = 1,
                 data_prefetch: int = 2, bucket_by_length: bool = False,
                 obs=None, tracer=None, profile_window=None,
                 hlo_check: bool = False):
        self.device = resolve_device(device)
        plan = as_plan(plan)
        self.cfg = with_kernels(plan.apply_to(cfg))
        self.built = build_plan(plan, self.cfg, self.device, ranks)
        self.plan = self.built.plan
        self.graphs = graphs_lib.use_graphs(
            graphs, self.device, collectives=self.built.backend)
        self.seed = seed
        self.batch_size = batch_size
        self.n_recycle = n_recycle
        self.recycle_sample = recycle_sample
        self.max_recycle = max_recycle or cfg.max_recycle
        self.eval_every = eval_every
        self.eval_batches = eval_batches
        self.eval_batch_size = eval_batch_size
        self.eval_n_recycle = eval_n_recycle or self.max_recycle
        self.ckpt_every = ckpt_every
        self.data_source = data_source
        self.data_workers = data_workers
        self.data_prefetch = data_prefetch
        self.bucket_by_length = bucket_by_length
        self.dtype = dtype
        self.optimizer = optimizer or optim_lib.adamw(
            optim_lib.af2_lr_schedule(1e-3, warmup_steps=100),
            per_sample_clip=0.1)
        self.ema = optim_lib.ema(ema_decay) if ema_decay else None
        self.obs = obs if obs is not None else MetricRegistry()
        self.tracer = tracer
        self.profile_window = profile_window
        self.hlo_check = hlo_check
        self._body = make_step_body(self.cfg, self.optimizer, self.built,
                                    deterministic=deterministic, ema=self.ema,
                                    dtype=dtype)
        if model is None:
            model = AlphaFold2(self.cfg, seed=seed, device=self.device)
        self.state = init_state(model, self.optimizer, self.ema,
                                compress_err=self.plan.compress_pod_grads)
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self._steps: dict = {}          # n_recycle -> its step
        self._batch_keys: Optional[list] = None
        self._eval_eng: Optional[FoldEngine] = None
        self.step = 0
        self.mgr = (CheckpointManager(ckpt_dir, keep=keep,
                                      install_sigterm=install_sigterm,
                                      plan_meta=self.built.metadata(),
                                      write=self.built.is_writer,
                                      obs=self.obs)
                    if ckpt_dir else None)
        self.watchdog = StepWatchdog(on_straggler=on_straggler)
        # live views: history[k] is the registry's series, the same object
        self.history = {k: self.obs.series(f"train/{k}") for k in
                        ("loss", "n_recycle", "step_s", "eval", "data",
                         "attribution")}
        self.last_metrics: dict = {}

    @property
    def model(self) -> AlphaFold2:
        return self.state["params"]

    # -- compile accounting -------------------------------------------------

    @property
    def train_compiles(self) -> int:
        """Training steps built so far: one per distinct ``n_recycle`` drawn,
        so at most ``max_recycle``.  The reference's count stays 1, since
        its draw is a traced loop bound; a CUDA graph has no data-dependent
        loop bound, so each draw is a graph of its own."""
        return len(self._steps)

    @property
    def eval_compiles(self) -> int:
        """The eval FoldEngine's ``compile_misses``: 1 once :meth:`evaluate`
        ran (one bucket), however often it runs."""
        return self._eval_eng.compile_misses if self._eval_eng else 0

    @property
    def compile_misses(self) -> int:
        return self.train_compiles + self.eval_compiles

    # -- stochastic recycling -----------------------------------------------

    def recycle_draw(self, step: int) -> int:
        """This step's ``n_recycle``: Uniform{1..max_recycle}, deterministic
        in (seed, step) — the reference's draw, number for number."""
        if not self.recycle_sample:
            return self.n_recycle
        gen = np.random.default_rng([abs(self.seed), step])
        return int(gen.integers(1, self.max_recycle + 1))

    # -- the step -----------------------------------------------------------

    def step_for(self, n_recycle: int):
        """The training step of this draw, built once: ``step(*tensors)``
        over the batch's tensors (sorted by key), the dropout key lanes and
        the optimizer step; a ``graphs.CapturedStep`` when graphed."""
        if n_recycle not in self._steps:
            fn = functools.partial(self._run_body, n_recycle)
            self._steps[n_recycle] = (
                graphs_lib.CapturedStep(fn, pool=self._pool) if self.graphs
                else fn)
        return self._steps[n_recycle]

    def _run_body(self, n_recycle: int, *tensors):
        n = len(self._batch_keys)
        return self._body(self.state, dict(zip(self._batch_keys, tensors[:n])),
                          *tensors[n:], n_recycle)

    @property
    def batch_keys(self) -> Optional[list]:
        """The batch's keys in the order the step takes their tensors."""
        return self._batch_keys

    def step_args(self, step: int, batch: dict) -> tuple:
        """The tensors a step of this runner takes for global step
        ``step`` and ``batch``: this replica's batch tensors (in
        :attr:`batch_keys` order), the dropout key lanes and the
        optimizer's new step count, on the runner's device."""
        batch, key, opt_step = step_inputs(batch, (self.seed, step),
                                           self.state["opt"].step + 1,
                                           self.device, self.built)
        if self._batch_keys is None:
            self._batch_keys = sorted(batch)
        elif sorted(batch) != self._batch_keys:
            raise ValueError(f"batch keys {sorted(batch)} != the step's "
                             f"{self._batch_keys}")
        return (*(batch[k] for k in self._batch_keys), key, opt_step)

    def _train_step(self, step: int, batch: dict, nr: int) -> dict:
        out = self.step_for(nr)(*self.step_args(step, batch))
        # read now: the next replay of any graph of the pool overwrites them
        metrics = {k: float(v) for k, v in zip(METRICS, out)}
        opt = self.state["opt"]
        self.state["opt"] = opt._replace(step=opt.step + 1)
        return metrics

    def record_async_overlap(self, batch: dict,
                             step: Optional[int] = None) -> dict:
        """Trace the ungraphed step body once on ``batch`` (global step
        ``step``, default ``self.step``, with that step's recycle draw),
        check its async collectives for overlap
        (``analysis.overlap.check_async_overlap``) and record the verdict,
        or why there is none, as ``train/async_overlap_ok`` with the
        reference's keys (``ok``, ``skipped``, ``reason``, and ``pairs``,
        ``overlapped``, ``exposed`` when there were pairs).  The state's
        tensors are copied before and restored after, so the parameters,
        moments, EMA, step count and ``train_compiles`` stay as they
        were."""
        from repro_torch.analysis.overlap import check_async_overlap
        from repro_torch.analysis.static.op_walk import capture
        from repro_torch.analysis.static.program import state_tensors
        step = self.step if step is None else step
        live = state_tensors(self.state)
        saved = {k: t.detach().clone() for k, t in live.items()}
        try:
            trace, _ = capture(
                functools.partial(self._run_body, self.recycle_draw(step)),
                *self.step_args(step, batch))
            ok, rep = check_async_overlap(trace)
        except Exception as e:  # keep training even if the trace fails
            ok, rep = None, {"error": f"{type(e).__name__}: {e}"}
        finally:
            with torch.no_grad():
                for k, t in live.items():
                    t.copy_(saved[k])
        row = {"ok": ok, "skipped": ok is None,
               "reason": (None if ok is not None else rep.get(
                   "error", "no async collective start/wait pairs in the "
                            "step"))}
        for k in ("pairs", "overlapped", "exposed"):
            if k in rep:
                row[k] = rep[k]
        self.obs.record("train/async_overlap_ok", row, step=self.step)
        return row

    def attribution(self, *, measured_step_s: float, n_recycle: float,
                    stall_fraction: float = 0.0, overhead_s: float = 0.0,
                    wall_s: Optional[float] = None,
                    step: Optional[int] = None) -> dict:
        """The roofline-against-measured row of this runner's config and
        plan (``obs.attribution_report``), recorded in
        ``history["attribution"]``."""
        rep = attribution_report(
            self.cfg, self.plan, global_batch=self.batch_size,
            n_recycle=n_recycle, measured_step_s=measured_step_s,
            stall_fraction=stall_fraction, overhead_s=overhead_s,
            wall_s=wall_s, step=step)
        self.obs.record("train/attribution", rep, step=step)
        return rep

    def run(self, steps: int, *, log_every: int = 0, log=print) -> dict:
        """Train until global step ``steps`` (continuing from ``self.step``),
        reading batches from :meth:`make_pipeline`, evaluating every
        ``eval_every`` steps (with the pipeline's report and an attribution
        row over the steps since the last one) and saving every
        ``ckpt_every`` steps before ``steps`` and once at the end (then
        waiting for the write); returns ``history``."""
        pipeline = self.make_pipeline()
        tracer = self.tracer if self.tracer is not None else get_tracer()
        obs = self.obs
        h_step = obs.histogram("train/step_s")
        c_steps = obs.counter("train/steps")
        # the attribution window restarts at each row
        win_t0 = time.perf_counter()
        win_i0 = len(self.history["step_s"])
        win_overhead = 0.0
        try:
            for step, batch in pipeline:
                if step >= steps:
                    break
                if self.profile_window is not None:
                    self.profile_window.maybe_start(step)
                if self.hlo_check and not self.history["step_s"]:
                    self.record_async_overlap(batch, step)
                nr = self.recycle_draw(step)
                self.watchdog.start_step()
                with trace_span("step", tracer=tracer, step=step,
                                n_recycle=nr):
                    metrics = self._train_step(step, batch, nr)
                    if self.device.type == "cuda":
                        # the span ends when the card has finished the step
                        torch.cuda.synchronize(self.device)
                self.watchdog.end_step(step)
                dt = self.watchdog.ema or 0.0
                self.last_metrics = metrics
                obs.record("train/loss", metrics["loss"], step=step)
                obs.record("train/n_recycle", nr, step=step)
                obs.record("train/step_s", dt, step=step)
                h_step.observe(dt)
                c_steps.inc()
                self.step = step + 1
                if log_every and step % log_every == 0:
                    log(f"step {step:5d}  loss {metrics['loss']:.4f}  "
                        f"n_recycle {nr}  "
                        f"({self.batch_size / max(dt, 1e-9):.2f} protein/s)")
                if self.eval_every and self.step % self.eval_every == 0:
                    t_ev = time.perf_counter()
                    with trace_span("eval", tracer=tracer, step=self.step):
                        ev = self.evaluate()
                    win_overhead += time.perf_counter() - t_ev
                    obs.record("train/eval",
                               {"step": self.step, "lddt_ca": ev["lddt_ca"]},
                               step=self.step)
                    obs.record("train/data",
                               dict(pipeline.report.as_dict(), step=self.step),
                               step=self.step)
                    win = self.history["step_s"][win_i0:]
                    nrs = self.history["n_recycle"][win_i0:]
                    attr = self.attribution(
                        measured_step_s=(sum(win) / len(win)) if win else 0.0,
                        n_recycle=(sum(nrs) / len(nrs)) if nrs else
                        float(self.n_recycle),
                        stall_fraction=pipeline.report.stall_fraction,
                        overhead_s=win_overhead,
                        wall_s=time.perf_counter() - win_t0, step=self.step)
                    win_t0 = time.perf_counter()
                    win_i0 = len(self.history["step_s"])
                    win_overhead = 0.0
                    if log_every:
                        log(f"  eval @ {self.step}: lDDT-Cα "
                            f"{ev['lddt_ca']:.2f} (ema={self.ema is not None},"
                            f" {self.batch_size / max(dt, 1e-9):.2f}"
                            f" protein/s)")
                        log(f"  {pipeline.report.describe()}")
                        log(f"  {describe_attribution(attr)}")
                if (self.mgr and self.step % self.ckpt_every == 0
                        and self.step < steps):
                    t_ck = time.perf_counter()
                    with trace_span("checkpoint", tracer=tracer,
                                    step=self.step):
                        self.save()
                    win_overhead += time.perf_counter() - t_ck
                obs.tick(step=step)
                if self.profile_window is not None:
                    self.profile_window.maybe_stop(step)
        finally:
            obs.record("train/data",
                       dict(pipeline.report.as_dict(), step=self.step),
                       step=self.step)
            pipeline.close()
            if self.profile_window is not None:
                self.profile_window.close()
        if self.mgr:
            with trace_span("checkpoint", tracer=tracer, step=self.step):
                self.save()
                self.mgr.wait()
        obs.tick(step=self.step)
        return self.history

    # -- the input pipeline -------------------------------------------------

    def make_pipeline(self) -> DataPipeline:
        """The input pipeline from ``self.step``: the synthetic stream, or
        records padded onto the config's training bucket (one step shape
        for every batch); batches placed on the runner's device one step
        ahead when it is a card."""
        return DataPipeline(
            self.cfg, source=self.data_source, batch_size=self.batch_size,
            seed=self.seed, start_step=self.step, workers=self.data_workers,
            prefetch=self.data_prefetch,
            bucket_by_length=self.bucket_by_length,
            pad_to=(train_bucket(self.cfg) if self.data_source is not None
                    else None),
            device=self.device, obs=self.obs, tracer=self.tracer)

    # -- checkpoints --------------------------------------------------------

    def checkpoint_tree(self) -> dict:
        """The train state in the reference's checkpoint layout, its leaves
        the live tensors (``checkpoint.train_state_tree``)."""
        return train_state_tree(self.state)

    def save(self) -> None:
        """Checkpoint the state at ``self.step`` (written asynchronously)."""
        if self.mgr is None:
            raise ValueError("TrainRunner has no ckpt_dir; nothing to save to")
        self.mgr.save(self.step, self.checkpoint_tree())

    def restore(self, *, adapt_plan: bool = False,
                step: Optional[int] = None) -> int:
        """Resume from the latest checkpoint (or the one at ``step``): the
        parameters, moments and EMA are copied into the tensors they live in
        (the training graphs and the eval engine keep their addresses), and
        the optimizer's step and ``self.step`` are set.  Returns the step."""
        if self.mgr is None:
            raise ValueError("TrainRunner has no ckpt_dir; nothing to restore")
        self.mgr.wait()
        self.built.barrier()    # the writer's last save is on disk
        tree, step = self.mgr.restore(self.checkpoint_tree(), step=step,
                                      adapt_plan=adapt_plan)
        self.state["opt"] = self.state["opt"]._replace(
            step=int(tree["opt"].step))
        self.step = step
        return step

    # -- evaluation ---------------------------------------------------------

    def eval_params(self):
        """The weights evaluation runs with: the EMA (fp32 by key path) when
        enabled, else the raw parameters (the model)."""
        return self.state.get("ema", self.model)

    def _eval_engine(self) -> FoldEngine:
        """The serving engine evaluation runs through, built once: one
        full-shape bucket, ``eval_batch_size`` proteins a step, exactly
        ``eval_n_recycle`` cycles (tol 0), graphed as training is, under
        the training plan's inference layout (``for_inference``: branch
        folds into data, dap stays).  It holds its own weights in the
        compute dtype, which :meth:`evaluate` loads before each use; its
        graphs keep their addresses."""
        if self._eval_eng is None:
            cfg = self.cfg
            self._eval_eng = FoldEngine(
                cfg, self.model,
                buckets=[fs.Bucket(cfg.n_res, cfg.n_seq, cfg.n_extra_seq)],
                micro_batch=self.eval_batch_size,
                max_recycle=self.eval_n_recycle, tol=0.0, dtype=self.dtype,
                device=self.device, graphs=self.graphs, plan=self.plan,
                ranks=self.built.ranks)
        return self._eval_eng

    @torch.no_grad()
    def evaluate(self) -> dict:
        """lDDT-Cα over the held-out split (``protein_batch(split='val')``)
        with the EMA parameters: ``core.model.predict`` with tol 0 (exactly
        ``eval_n_recycle`` cycles) through the eval engine's step, scored by
        ``heads.lddt_ca``.  Returns the mean ``lddt_ca``, the ``per_sample``
        scores and the ``coords``, ``true_trans`` and ``res_mask`` they came
        from (numpy)."""
        eng = self._eval_engine()
        eng.load_weights(self.eval_params())
        bucket = eng.buckets[0]
        step = eng.step_for(bucket)
        ext = eng.slots_for(bucket)
        keys = fs.REQUEST_FEATURE_KEYS + ("res_mask",)
        lddts, coords, truths, masks = [], [], [], []
        for b in range(self.eval_batches):
            batch = protein_batch(self.seed, b, self.eval_batch_size,
                                  self.cfg, split="val")
            fb = {k: batch[k] for k in keys}
            if ext > self.eval_batch_size:      # round up to the plan's data
                fb = {k: np.concatenate(        # extent; the extras dropped
                    [v, np.repeat(v[-1:], ext - self.eval_batch_size, 0)])
                    for k, v in fb.items()}
            out = step(eng.params, fb)
            c = out["coords"][:self.eval_batch_size].float()
            truth = to_device({k: batch[k] for k in ("true_trans", "res_mask")},
                              c.device)
            lddts.append(torch.stack([
                heads_lib.lddt_ca(c[i], truth["true_trans"][i],
                                  truth["res_mask"][i])
                for i in range(self.eval_batch_size)]).cpu().numpy())
            coords.append(c.cpu().numpy())
            truths.append(batch["true_trans"])
            masks.append(batch["res_mask"])
        lddts = np.concatenate(lddts)
        return {"lddt_ca": float(lddts.mean()), "per_sample": lddts,
                "coords": np.concatenate(coords),
                "true_trans": np.concatenate(truths),
                "res_mask": np.concatenate(masks)}
