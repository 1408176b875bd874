"""Serving launcher of the PyTorch port: LM batched decode through
``DecodeEngine`` on one device, or tensor-parallel over ``--devices``
rank processes on a (devices / tp, tp) mesh over ("data", "model")
(``--arch``: the dense, moe, ssm and hybrid families; prefill attention on
the flash kernel K6), or AF2 fold serving of
a mixed-length synthetic queue through ``FoldEngine`` (``--fold``; every
attention and triangle update on the hand-written kernels), on one device
or over ``--devices`` rank processes with a DAP plan for the long buckets.

  # on the GPU (the default device)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \
      --requests 8 --slots 4 --max-new 32 --prompt-len 2048 --max-len 4096
  PYTHONPATH=src python -m repro_torch.launch.serve --fold initial \
      --requests 4 --micro-batch 2 --max-recycle 3
  # on the CPU (the kernels' plain versions), small shapes
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --smoke \
      --device cpu --requests 3 --slots 2 --max-new 4 --prompt-len 8 --max-len 32
  PYTHONPATH=src python -m repro_torch.launch.serve --fold tiny --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --smoke \
      --device cpu --requests 3 --slots 2 --max-new 4 --prompt-len 8 --max-len 32
  # tensor-parallel over two CPU ranks: each holds its slices of the
  # weights and its KV heads; rank 0 reports
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --smoke \
      --device cpu --devices 2 --tp 2 --requests 3 --slots 2 --max-new 4 \
      --prompt-len 8 --max-len 32
  # two rank processes (CPU ranks over gloo; on the card, ranks that share
  # it talk over gloo and serve without graphs): the longest bucket runs
  # under long_plan = ParallelPlan(data=devices // dap, dap=dap), the
  # others on each rank alone; every rank serves the same requests
  PYTHONPATH=src python -m repro_torch.launch.serve --fold tiny --device cpu \
      --devices 2 --dap 2 --requests 3
  # sustained traffic (--arrival-rate > 0): FoldEngine.serve, Poisson
  # arrivals on a virtual clock, continuous batching and the result cache
  PYTHONPATH=src python -m repro_torch.launch.serve --fold initial \
      --requests 8 --arrival-rate 4 --deadline-slack 3 --featurize-workers 2
  PYTHONPATH=src python -m repro_torch.launch.serve --fold tiny --device cpu \
      --arrival-rate 2 --cache-capacity 8 --duplicates 0.3
  # telemetry of the fold path: serve/* counters, per-call deltas and the
  # report as JSONL; admit / recycle_step / harvest / fold_step spans as a
  # Chrome trace (open in ui.perfetto.dev)
  PYTHONPATH=src python -m repro_torch.launch.serve --fold tiny --device cpu \
      --arrival-rate 2 --metrics-out serve.jsonl --trace-out serve_trace.json
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="LM arch id (decode serving)")
    ap.add_argument("--fold", choices=["tiny", "small", "initial", "finetune"],
                    help="AF2 config (fold serving)")
    ap.add_argument("--smoke", action="store_true",
                    help="--arch: the reduced config of the same family")
    ap.add_argument("--requests", type=int, default=6)
    # LM decode knobs
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    # fold knobs
    ap.add_argument("--devices", type=int, default=1,
                    help="rank processes to spawn (the reference's fake "
                         "host devices; 1: this process alone); every rank "
                         "serves the same requests")
    ap.add_argument("--tp", type=int, default=1,
                    help="--arch: tensor-parallel extent, the mesh's "
                         "'model' axis ((devices / tp, tp) over ('data', "
                         "'model'))")
    ap.add_argument("--dap", type=int, default=1,
                    help="--fold: dap extent of the long buckets' plan, "
                         "which must divide --devices")
    ap.add_argument("--micro-batch", type=int, default=2)
    ap.add_argument("--max-recycle", type=int, default=3)
    ap.add_argument("--tol", type=float, default=0.0,
                    help="early-exit recycling tolerance (fraction of "
                         "changed CA-distance bins; 0 = fixed recycling)")
    ap.add_argument("--seed", type=int, default=0)
    # sustained traffic: --arrival-rate > 0 serves Poisson arrivals through
    # FoldEngine.serve instead of draining a queue through run
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="offered load in requests per virtual second; > 0 "
                         "serves through the continuous-batching serve()")
    ap.add_argument("--policy", choices=["continuous", "fifo"],
                    default="continuous",
                    help="admission policy (fifo: run()'s drain order)")
    ap.add_argument("--cache-capacity", type=int, default=64,
                    help="result cache entries (0: no cache)")
    ap.add_argument("--deadline-slack", type=float, default=0.0,
                    help="deadline = arrival + this many virtual seconds "
                         "(0: no deadlines)")
    ap.add_argument("--duplicates", type=float, default=0.3,
                    help="fraction of requests repeating an earlier "
                         "request's features (cache hits)")
    ap.add_argument("--featurize-workers", type=int, default=0,
                    help="featurize-stage threads (0: inline)")
    ap.add_argument("--starvation-steps", type=int, default=16,
                    help="steps a lane with work waiting may be passed "
                         "over before it runs next")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--metrics-out", default="",
                    help="--fold: write the metric stream (serve/* "
                         "counters, per-call deltas, report gauges) as JSONL "
                         "to this path")
    ap.add_argument("--trace-out", default="",
                    help="--fold: write the host spans (admit, "
                         "recycle_step, harvest, fold_step) as Chrome-trace "
                         "JSON to this path")
    args = ap.parse_args(argv)
    if bool(args.arch) == bool(args.fold):
        raise SystemExit("pass one of --arch <lm-arch> (decode) and --fold "
                         "<tiny|small|initial|finetune> (AF2)")
    if args.fold:
        if args.tp != 1:
            raise SystemExit("--tp splits an LM over 'model' (--arch); "
                             "fold serving takes --dap")
        return run_fold(args)
    if args.devices > 1:
        return launch_lm_decode(args)
    return run_lm_decode(args)


def launch_lm_decode(args):
    """``run_lm_decode`` on ``--devices`` rank processes; rank 0's
    result."""
    import torch

    from repro_torch.parallel import ranks
    if args.devices % args.tp:
        raise SystemExit(f"--tp {args.tp} does not divide --devices "
                         f"{args.devices}")
    device_type = ranks.resolve_device_type(args.device)
    backend = ranks.choose_backend(device_type, args.devices)
    print(ranks.describe_backend(device_type, backend, args.devices))
    if device_type == "cuda":
        from repro_torch.kernels import build
        build.build_all()       # once, before the ranks start
    return ranks.spawn(_lm_rank, args.devices, args, device_type=device_type,
                       backend=backend,
                       threads=max(1, torch.get_num_threads() // args.devices)
                       if device_type == "cpu" else 0)[0]


def _lm_rank(rank, world, device, args):
    return run_lm_decode(args, rank=rank, world=world, device=device)


def run_lm_decode(args, *, rank: int = 0, world: int = 1, device=None):
    """Serve ``--requests`` prompts on one device, or as rank ``rank`` of
    ``world`` on a (world / tp, tp) mesh, each rank drawing its slices of
    the weights (``serve.steps.serve_layout``); rank 0 prints."""
    import numpy as np
    import torch

    from repro_torch import configs as cfglib
    from repro_torch.device import resolve_device
    from repro_torch.models import get_model
    from repro_torch.models.lmconfig import with_kernels
    from repro_torch.serve.engine import DecodeEngine, Request

    try:
        cfg = (cfglib.get_smoke_config(args.arch) if args.smoke
               else cfglib.get_config(args.arch))
    except KeyError:
        raise SystemExit(
            f"unknown --arch {args.arch!r}; known LM archs: "
            f"{', '.join(cfglib.ARCH_IDS)}.  AF2 fold serving uses --fold "
            "<tiny|small|initial|finetune> instead of --arch")
    if cfg.family in ("audio", "vlm"):
        raise SystemExit("serve demo supports token-prompt archs; "
                         "audio/vlm prefill needs frames/patches — see tests")
    cfg = with_kernels(cfg)
    model = get_model(cfg)
    dev = device if device is not None else resolve_device(args.device)
    mesh = cut = None
    if world > 1:
        from repro_torch.parallel.mesh_utils import make_mesh
        from repro_torch.serve.steps import serve_layout
        mesh = make_mesh((world // args.tp, args.tp), ("data", "model"))
        cut = serve_layout(model, cfg, mesh).cut
    params = model.init_params(cfg, seed=args.seed, device=dev,
                               dtype=torch.bfloat16, cut=cut)
    engine = DecodeEngine(model, cfg, params, batch_slots=args.slots,
                          max_len=args.max_len, device=dev, mesh=mesh)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = engine.run(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in done.values())
    if rank:
        return done
    where = (f"{world} ranks, mesh (data {world // args.tp}, model "
             f"{args.tp})" if world > 1 else str(engine.device))
    print(f"{cfg.arch_id} ({cfg.n_layer} layers, d {cfg.d_model}) on "
          f"{where}: served {len(done)} requests, {total} tokens in "
          f"{dt:.1f}s ({total / dt:.1f} tok/s aggregate)")
    for rid in sorted(done)[:3]:
        print(f"  req {rid}: {done[rid][:10]}...")
    return done


def run_fold(args):
    """``--fold``: on this process, or over ``--devices`` rank processes,
    each serving the same requests (rank 0's results are returned)."""
    from repro_torch.parallel import ranks
    from repro_torch.parallel.plan import ParallelPlan

    if args.dap > 1 and args.devices % args.dap:
        raise SystemExit(
            f"--dap {args.dap} does not divide the {args.devices} available "
            f"devices; pass --devices as a multiple of --dap")
    long_plan = (ParallelPlan(data=args.devices // args.dap, dap=args.dap)
                 if args.dap > 1 else None)
    if long_plan is not None:
        check_long_plan(args.fold, long_plan)
    if args.devices <= 1:
        return serve_folds(args, long_plan)
    if args.featurize_workers:
        raise SystemExit("--featurize-workers must be 0 with --devices > 1: "
                         "every rank must admit the same requests at the "
                         "same steps, and thread timing differs by rank")
    import torch
    from repro_torch.device import resolve_device
    device_type = resolve_device(args.device).type
    backend = ranks.choose_backend(device_type, args.devices)
    print(ranks.describe_backend(device_type, backend, args.devices))
    if device_type == "cuda":
        from repro_torch.kernels import build
        build.build_all()           # once, before the ranks start
    done = ranks.spawn(_fold_rank, args.devices, args, long_plan,
                       device_type=device_type, backend=backend,
                       # CPU ranks split this process's intra-op threads
                       threads=max(1, torch.get_num_threads() // args.devices)
                       if device_type == "cpu" else 0)
    return done[0]


def check_long_plan(fold: str, long_plan) -> None:
    """Refuse a long plan that cannot split the buckets it would run, as the
    reference refuses it when it builds its engine ("fold plan rejected");
    the port's engine would find it at the bucket's first step, inside the
    rank processes."""
    from repro_torch.core.config import PRESETS
    from repro_torch.parallel.plan import PlanError
    from repro_torch.serve import fold_steps as fs

    cfg = PRESETS[fold]()
    plan = long_plan.for_inference()
    buckets = sorted(fs.default_buckets(cfg))
    try:
        for b in buckets:
            if b.n_res >= buckets[-1].n_res:     # FoldEngine.long_threshold
                plan.validate(plan.apply_to(fs.bucket_cfg(cfg, b)))
    except PlanError as e:
        raise SystemExit(f"fold plan rejected: {e}")


def _fold_rank(rank, world, device, args, long_plan):
    return serve_folds(args, long_plan, device=device, rank=rank)


def serve_folds(args, long_plan, *, device=None, rank: int = 0):
    """Build the engine (``long_plan`` for buckets of the largest one's
    length and up, one device for the rest) and serve the synthetic
    requests; only rank 0 prints and writes the telemetry files."""
    from repro_torch.core.config import PRESETS
    from repro_torch.core.model import AlphaFold2
    from repro_torch.data.synthetic import make_fold_requests
    from repro_torch.obs import JsonlSink, MetricRegistry, SpanTracer
    from repro_torch.serve.fold_engine import FoldEngine

    lead = rank == 0
    device = device if device is not None else args.device
    cfg = PRESETS[args.fold]()
    model = AlphaFold2(cfg, seed=args.seed, device=device)
    obs = MetricRegistry(sinks=[JsonlSink(args.metrics_out)]
                         if args.metrics_out and lead else [])
    tracer = (SpanTracer(process_name="fold-serve")
              if args.trace_out and lead else None)
    engine = FoldEngine(cfg, model, long_plan=long_plan,
                        micro_batch=args.micro_batch,
                        max_recycle=args.max_recycle, tol=args.tol,
                        device=device, obs=obs, tracer=tracer)
    if lead:
        print(f"fold engine: {args.fold} cfg on {engine.device}, "
              f"{args.devices} rank(s), buckets "
              f"{[b.describe() for b in engine.buckets]}")
        print(f"  short plan {engine.plan.describe()}")
        if long_plan is not None:
            print(f"  long plan  {engine.long_plan.describe()} "
                  f"(>= {engine.long_threshold} res)")
    reqs = make_fold_requests(cfg, args.requests, args.seed)
    if args.arrival_rate > 0:
        done = run_fold_traffic(args, engine, reqs, lead)
        if lead:
            finish_fold_obs(args, engine)
        return done
    t0 = time.perf_counter()
    done = engine.run(reqs)
    dt = time.perf_counter() - t0
    st = engine.last_stats
    saved = st["recycles_budget"] - st["recycles_run"]
    if lead:
        print(f"served {len(done)} folds in {dt:.1f}s "
              f"({len(done) / dt:.2f} folds/s aggregate), "
              f"{engine.compile_misses} step builds over {st['steps']} "
              f"steps, {saved}/{st['recycles_budget']} recycles saved by "
              f"early exit")
        for rid in sorted(done)[:4]:
            r = done[rid]
            print(f"  req {rid}: len={r.coords.shape[0]} bucket<= "
                  f"{r.bucket.n_res} plddt={r.plddt.mean():.1f} "
                  f"recycles={r.n_recycles} converged={r.converged}")
        finish_fold_obs(args, engine)
    return done


def finish_fold_obs(args, engine):
    """Write the fold engine's metric stream and host trace to disk."""
    engine.obs.tick()
    if engine.tracer is not None and args.trace_out:
        engine.tracer.save(args.trace_out)
        print(f"trace: {len(engine.tracer.spans())} spans -> "
              f"{args.trace_out}")
    engine.obs.close()
    if args.metrics_out:
        print(f"metrics: JSONL stream -> {args.metrics_out}")


def run_fold_traffic(args, engine, reqs, lead: bool = True):
    """Sustained traffic through ``FoldEngine.serve``: ``reqs`` as Poisson
    arrivals at ``--arrival-rate`` drawn from ``--seed``, a
    ``--duplicates`` fraction repeating an earlier request's features,
    deadlines ``--deadline-slack`` after arrival; step costs the measured
    walls."""
    from repro_torch.serve.result_cache import ResultCache
    from repro_torch.serve.scheduler import VirtualClock

    rng = np.random.default_rng(args.seed)
    t, traffic = 0.0, []
    for r in reqs:
        feats = (traffic[rng.integers(0, len(traffic))].features
                 if traffic and rng.random() < args.duplicates
                 else r.features)
        t += float(rng.exponential(1.0 / args.arrival_rate))
        traffic.append(dataclasses.replace(
            r, features=feats, arrival_s=t,
            deadline_s=(t + args.deadline_slack
                        if args.deadline_slack > 0 else None)))
    cache = ResultCache(args.cache_capacity) if args.cache_capacity else None
    done = engine.serve(traffic, policy=args.policy, clock=VirtualClock(),
                        cache=cache,
                        featurize_workers=args.featurize_workers,
                        starvation_steps=args.starvation_steps)
    if not lead:
        return done
    rep = engine.last_report
    print(f"served {len(done)}/{rep['requests']} folds under "
          f"{args.arrival_rate:.2f} req/s ({args.policy}): "
          f"p50 {rep['p50_ms']:.0f}ms p99 {rep['p99_ms']:.0f}ms, "
          f"goodput {rep['goodput_rps']:.2f} req/s, "
          f"on-time {rep['on_time_frac']:.0%}")
    sm = rep["stage_ms"]
    print(f"  stages: featurize {sm['featurize']:.2f}ms | queue "
          f"{sm['queue']:.0f}ms | service {sm['service']:.0f}ms; "
          f"utilization {rep['utilization']:.0%}, "
          f"{rep['steps']} steps, {engine.compile_misses} compiles, "
          f"cache hit rate {rep['hit_rate']:.0%}, "
          f"{rep['forced_admissions']} forced admissions")
    return done


if __name__ == "__main__":
    main()
