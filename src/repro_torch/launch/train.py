"""Training launcher of the PyTorch port: ``TrainRunner`` on one device or
over rank processes under a ``ParallelPlan``, every attention and triangle
update on the hand-written kernels.

  # on the GPU (the default device)
  PYTHONPATH=src python -m repro_torch.launch.train --af2 initial --steps 3 --batch 1
  # on the CPU (the kernels' plain versions), small shapes, evaluating at step 2
  PYTHONPATH=src python -m repro_torch.launch.train --af2 tiny --steps 2 --batch 1 --device cpu --eval-every 2
  # FASTA records (a deterministic demo set without --fasta), length-bucketed,
  # a checkpoint every step; then resume from the latest and train to step 4
  PYTHONPATH=src python -m repro_torch.launch.train --af2 tiny --steps 3 --batch 1 --device cpu --data-source fasta --bucket-by-length --ckpt-dir runs/tiny --ckpt-every 1
  PYTHONPATH=src python -m repro_torch.launch.train --af2 tiny --steps 4 --batch 1 --device cpu --data-source fasta --bucket-by-length --ckpt-dir runs/tiny --ckpt-every 1 --resume
  # four CPU rank processes (gloo), BP 2 x DAP 2
  PYTHONPATH=src python -m repro_torch.launch.train --af2 tiny --steps 2 --batch 1 --device cpu --devices 4 --bp 2 --dap 2
  # two rank processes on the card (gloo when they share one card, NCCL
  # when each has its own), DAP 2 with the overlapped schedule
  PYTHONPATH=src python -m repro_torch.launch.train --af2 initial --steps 2 --batch 1 --devices 2 --dap 2
  # or one process per rank started by torchrun (its environment is read)
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --af2 initial --steps 2 --batch 2
  # telemetry: the metric stream as JSONL, host spans as a Chrome trace
  # (open in ui.perfetto.dev), torch.profiler over steps [2, 3) into
  # trace.json.profile/, a console summary every 2 steps
  PYTHONPATH=src python -m repro_torch.launch.train --af2 tiny --steps 4 --batch 1 --device cpu --eval-every 2 --metrics-out metrics.jsonl --trace-out trace.json --profile-steps 2:3 --obs-every 2

``--devices N`` spawns N rank processes (the reference's fake host
devices); the backend and the route of every collective kind are printed.
Under rank processes every rank keeps its own registry, and only the
writer rank (the one that writes checkpoints) writes the telemetry files
and prints.
"""
from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--af2", choices=["tiny", "small", "initial"],
                    required=True, help="AF2 config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--recycle-sample", action="store_true",
                    help="draw n_recycle per step from 1..max_recycle "
                         "(stochastic recycling); else one cycle")
    ap.add_argument("--max-recycle", type=int, default=0,
                    help="upper bound of the draw (0: the config's)")
    ap.add_argument("--ema", type=float, default=0.999,
                    help="EMA decay of the eval parameters (0: no EMA)")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="lDDT-Cα evaluation of the EMA parameters on the "
                         "held-out split every N steps (0: off)")
    ap.add_argument("--data-workers", type=int, default=1,
                    help="host featurize worker threads (0: featurize "
                         "inline in the training loop, no overlap)")
    ap.add_argument("--data-source", choices=["synthetic", "fasta"],
                    default="synthetic",
                    help="'synthetic': the deterministic protein_batch "
                         "stream; 'fasta': record ingest (parse, MSA stack, "
                         "featurize_record) over --fasta or a demo set")
    ap.add_argument("--fasta", default="",
                    help="FASTA file for --data-source fasta (empty: "
                         "deterministic demo records)")
    ap.add_argument("--bucket-by-length", action="store_true",
                    help="group records of similar length per batch (record "
                         "sources only; batches still pad to the config's "
                         "training bucket, so the step keeps one shape)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint of --ckpt-dir first")
    ap.add_argument("--adapt-plan", action="store_true",
                    help="allow --resume from a checkpoint written under a "
                         "different ParallelPlan")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device type of every rank (default: cuda, "
                         "which must exist)")
    ap.add_argument("--variant", default="parallel",
                    choices=["af2", "multimer", "parallel"])
    ap.add_argument("--devices", type=int, default=1,
                    help="rank processes to spawn (1: this process alone; "
                         "ignored under torchrun)")
    ap.add_argument("--bp", type=int, default=1)
    ap.add_argument("--dap", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--auto-plan", action="store_true",
                    help="pick the DP x BP x DAP split from the roofline "
                         "cost model (overrides --bp/--dap)")
    ap.add_argument("--overlap-dap", choices=["auto", "on", "off"],
                    default="auto",
                    help="communication-overlapped DAP schedule: 'auto' "
                         "enables it for pure-DAP 'parallel' groups, "
                         "'on'/'off' force it (on is rejected for hybrid / "
                         "serial plans)")
    ap.add_argument("--compress-pod-grads", action="store_true",
                    help="int8 error-feedback compression of the cross-pod "
                         "gradient sum (needs --pods > 1)")
    ap.add_argument("--rank-timeout", type=float, default=3600.0,
                    help="seconds a rank process may take, and the timeout "
                         "of every collective")
    ap.add_argument("--metrics-out", default="",
                    help="write the metric stream (loss, step_s, data "
                         "stalls, attribution, checkpoint timings) as JSONL "
                         "to this path")
    ap.add_argument("--trace-out", default="",
                    help="write the host spans (featurize, device_put, "
                         "input_wait, step, eval, checkpoint) as Chrome-trace "
                         "JSON to this path; open it in ui.perfetto.dev or "
                         "chrome://tracing")
    ap.add_argument("--profile-steps", default="",
                    help="'A:B': capture steps [A, B) with torch.profiler, "
                         "aligned to the spans' step ids; the trace goes to "
                         "<trace-out>.profile/ (or ./torch_profile)")
    ap.add_argument("--obs-every", type=int, default=0,
                    help="print a summary of the latest data/, train/ and "
                         "ckpt/ metrics every N steps (0: off)")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    from repro_torch.parallel import ranks
    device_type = resolve_device(args.device).type
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world, device, backend = ranks.from_env(device_type,
                                                      args.rank_timeout)
        if rank == 0:
            print(ranks.describe_backend(device_type, backend, world))
        return run_af2(args, rank=rank, world=world, device=device)
    if args.devices > 1:
        import torch
        backend = ranks.choose_backend(device_type, args.devices)
        print(ranks.describe_backend(device_type, backend, args.devices))
        if device_type == "cuda":
            from repro_torch.kernels import build
            build.build_all()       # once, before the ranks start
        return ranks.spawn(_rank_main, args.devices, args,
                           device_type=device_type, backend=backend,
                           timeout_s=args.rank_timeout,
                           # CPU ranks split this process's intra-op threads
                           threads=max(1, torch.get_num_threads() // args.devices)
                           if device_type == "cpu" else 0)
    return run_af2(args)


def _rank_main(rank, world, device, args):
    runner = run_af2(args, rank=rank, world=world, device=device)
    return {"loss": runner.history["loss"],
            "n_recycle": runner.history["n_recycle"]}


def make_plan(args, cfg, world: int):
    from repro_torch.parallel.plan import ParallelPlan, auto_plan
    overlap = {"auto": None, "on": True, "off": False}[args.overlap_dap]
    kw = dict(variant=args.variant, overlap_dap=overlap,
              compress_pod_grads=args.compress_pod_grads)
    if args.auto_plan:
        return auto_plan(world, cfg, global_batch=args.batch, pod=args.pods,
                         **kw)
    return ParallelPlan.from_flags(world, bp=args.bp, dap=args.dap,
                                   pod=args.pods, **kw)


def run_af2(args, *, rank: int = 0, world: int = 1, device=None):
    from repro_torch.core.config import PRESETS
    from repro_torch.nn.layers import count_params
    from repro_torch.obs import (ConsoleSink, JsonlSink, MetricRegistry,
                                 ProfileWindow, SpanTracer,
                                 describe_attribution, parse_profile_steps)
    from repro_torch.train.optim import adamw, af2_lr_schedule
    from repro_torch.train.trainer import TrainRunner

    cfg = PRESETS[args.af2]()
    plan = make_plan(args, cfg, world)
    device = device if device is not None else args.device
    print_ = print if rank == 0 else (lambda *a, **k: None)
    source = None
    if args.data_source == "fasta":
        from repro_torch.data.ingest import FastaSource, demo_fasta
        if args.fasta:
            source = FastaSource(args.fasta, cfg, is_path=True)
        else:
            source = FastaSource(demo_fasta(cfg, seed=args.seed), cfg,
                                 is_path=False)
        print_(f"data: fasta source, {len(source)} records"
               + (f" from {args.fasta}" if args.fasta else " (bundled demo)"))
    if args.bucket_by_length and source is None:
        raise SystemExit("--bucket-by-length needs --data-source fasta "
                         "(the synthetic stream is fixed-shape)")
    profile_steps = (parse_profile_steps(args.profile_steps)
                     if args.profile_steps else None)
    obs = MetricRegistry()
    # paper §5.2 / AF2 suppl. 1.11.3: clip each SAMPLE's gradient at 0.1
    opt = adamw(af2_lr_schedule(args.lr, warmup_steps=100),
                per_sample_clip=0.1)
    runner = TrainRunner(
        cfg, plan, optimizer=opt, batch_size=args.batch, seed=args.seed,
        recycle_sample=args.recycle_sample,
        max_recycle=args.max_recycle or None, ema_decay=args.ema or None,
        eval_every=args.eval_every, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, install_sigterm=True,
        deterministic=False, device=device, data_source=source,
        data_workers=args.data_workers,
        bucket_by_length=args.bucket_by_length, obs=obs,
        on_straggler=lambda s, dt, ema: print_(
            f"  [watchdog] step {s} took {dt:.2f}s (EMA {ema:.2f}s)"))
    # telemetry files: the writer rank's only, as checkpoints
    writer = runner.built.is_writer
    if writer and args.metrics_out:
        obs.add_sink(JsonlSink(args.metrics_out))
    if writer and args.obs_every:
        obs.add_sink(ConsoleSink(every=args.obs_every, log=print_,
                                 prefixes=("data/", "train/", "ckpt/")))
    if writer and args.trace_out:
        runner.tracer = SpanTracer()
    if writer and profile_steps:
        runner.profile_window = ProfileWindow(
            *profile_steps, (f"{args.trace_out}.profile" if args.trace_out
                             else "torch_profile"),
            log=print_, device=runner.device)
    print_(f"train: {args.af2} cfg on {runner.device}, params "
           f"{count_params(runner.model):,}, recycle_sample="
           f"{args.recycle_sample} (max {runner.max_recycle}), ema="
           f"{args.ema or 'off'}, graphs={runner.graphs}")
    print_(f"plan: {runner.plan.describe()}")
    for kind, route in runner.built.routes().items():
        print_(f"  collective {kind}: {route}")
    if args.ckpt_dir and args.resume:
        try:
            print_(f"resumed from step "
                   f"{runner.restore(adapt_plan=args.adapt_plan)}")
        except FileNotFoundError:
            pass
    t0 = time.time()
    runner.run(args.steps, log_every=args.log_every if rank == 0 else 0,
               log=print_)
    evals = runner.history["eval"]
    print_(f"done: {args.steps} steps in {time.time() - t0:.1f}s; last loss "
           f"{runner.history['loss'][-1]:.4f}; train compiles: "
           f"{runner.train_compiles}; stragglers flagged: "
           f"{len(runner.watchdog.flagged)}"
           + (f"; final lDDT-Cα {evals[-1]['lddt_ca']:.2f}" if evals else ""))
    data = runner.history["data"]
    if data:
        d = data[-1]
        print_(f"data ({args.data_workers} workers): stall "
               f"{d['stall_ms_per_step']}ms/step "
               f"({100 * d['stall_fraction']:.1f}% of loop), featurize "
               f"{d['featurize_ms_per_step']}ms, transfer "
               f"{d['transfer_ms_per_step']}ms, fill {d['mean_fill']:.2f}")
    # the whole run's attribution over history["step_s"], as the reference
    # attributes it: that is the watchdog's EMA, which the first step (a
    # capture on the card) seeds, so dropping that entry does not drop the
    # capture's cost; each step's own wall is its `step` span (--trace-out)
    step_s = runner.history["step_s"]
    settled = step_s[1:] or step_s
    if settled:
        nrs = runner.history["n_recycle"]
        attr = runner.attribution(
            measured_step_s=sum(settled) / len(settled),
            n_recycle=sum(nrs) / max(len(nrs), 1),
            stall_fraction=(data[-1]["stall_fraction"] if data else 0.0),
            wall_s=time.time() - t0, step=runner.step)
        print_(describe_attribution(attr))
    if runner.tracer is not None:
        runner.tracer.save(args.trace_out)
        print_(f"trace: {len(runner.tracer.spans())} spans -> "
               f"{args.trace_out}")
    obs.flush()
    obs.close()
    if writer and args.metrics_out:
        print_(f"metrics: JSONL stream -> {args.metrics_out}")
    return runner


if __name__ == "__main__":
    main()
