"""Fold-serving launcher of the PyTorch port: a mixed-length synthetic queue
through ``FoldEngine`` on one device, every attention and triangle update on
the hand-written kernels.

  # on the GPU (the default device)
  PYTHONPATH=src python -m repro_torch.launch.serve --fold initial \
      --requests 4 --micro-batch 2 --max-recycle 3
  # on the CPU (the kernels' plain versions), small shapes
  PYTHONPATH=src python -m repro_torch.launch.serve --fold tiny --device cpu
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fold", choices=["tiny", "small", "initial", "finetune"],
                    required=True, help="AF2 config")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--micro-batch", type=int, default=2)
    ap.add_argument("--max-recycle", type=int, default=3)
    ap.add_argument("--tol", type=float, default=0.0,
                    help="early-exit recycling tolerance (fraction of "
                         "changed CA-distance bins; 0 = fixed recycling)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    run_fold(args)


def run_fold(args):
    from repro_torch.core.config import PRESETS
    from repro_torch.core.model import AlphaFold2
    from repro_torch.data.synthetic import make_fold_requests
    from repro_torch.serve.fold_engine import FoldEngine

    cfg = PRESETS[args.fold]()
    model = AlphaFold2(cfg, seed=args.seed, device=args.device)
    engine = FoldEngine(cfg, model, micro_batch=args.micro_batch,
                        max_recycle=args.max_recycle, tol=args.tol,
                        device=args.device)
    print(f"fold engine: {args.fold} cfg on {engine.device}, buckets "
          f"{[b.describe() for b in engine.buckets]}")
    reqs = make_fold_requests(cfg, args.requests, args.seed)
    t0 = time.perf_counter()
    done = engine.run(reqs)
    dt = time.perf_counter() - t0
    st = engine.last_stats
    saved = st["recycles_budget"] - st["recycles_run"]
    print(f"served {len(done)} folds in {dt:.1f}s "
          f"({len(done) / dt:.2f} folds/s aggregate), "
          f"{engine.compile_misses} step builds over {st['steps']} steps, "
          f"{saved}/{st['recycles_budget']} recycles saved by early exit")
    for rid in sorted(done)[:4]:
        r = done[rid]
        print(f"  req {rid}: len={r.coords.shape[0]} bucket<= "
              f"{r.bucket.n_res} plddt={r.plddt.mean():.1f} "
              f"recycles={r.n_recycles} converged={r.converged}")
    return done


if __name__ == "__main__":
    main()
