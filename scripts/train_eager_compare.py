#!/usr/bin/env python3
"""Eager training walls of several checkouts of the port, one after the
other on one NVIDIA GPU: the way to compare two versions of the eager
training step within one call.

    python3 scripts/train_eager_compare.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout (its ``src/repro_torch`` is
imported, its kernels built into its own ``build/``); each runs in a
process of its own.  Per checkout: ``TrainRunner`` at af2_initial, batch
1, seed 1502, eager, from the port's seeded init with N(0, 0.02) added to
every parameter; 4 warm-up steps, steps 4-8 timed, step 9 under
torch.profiler.  Prints the card's name and power limit, then one
``RESULT`` JSON line per checkout: the draws, the raw wall of each step
from step 4 on, the losses and the number of device events (kernels and
copies) of the profiled step.

A step's raw wall is its ``step`` span (host clock, ending after the
step's synchronize) where the checkout has ``repro_torch.obs``; there
``history["step_s"]`` holds the step watchdog's EMA instead.  A checkout
without telemetry records the raw wall in ``history["step_s"]`` itself,
and that is what is read there, so every checkout reports the same
quantity.
"""
import json
import subprocess
import sys


def measure(root: str) -> None:
    sys.path.insert(0, root + "/src")
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.config import af2_initial
    from repro_torch.core.model import AlphaFold2
    from repro_torch.kernels import build
    from repro_torch.train.trainer import TrainRunner

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    cfg = af2_initial()
    model = AlphaFold2(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    kw = dict(batch_size=1, seed=1502, device="cuda", model=model.cuda())
    try:
        from repro_torch.obs import SpanTracer
        kw["tracer"] = tracer = SpanTracer()
    except ImportError:         # a checkout without telemetry
        tracer = None
    try:
        runner = TrainRunner(cfg, graphs=False, **kw)
    except TypeError:           # a checkout whose TrainRunner has no graphs
        runner = TrainRunner(cfg, **kw)
    runner.run(4)
    runner.run(9)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        runner.run(10)
        torch.cuda.synchronize()
    events = sum(e.count for e in prof.key_averages()
                 if e.device_type.name == "CUDA")
    walls = (runner.history["step_s"] if tracer is None
             else [e["dur"] / 1e6 for e in tracer.spans("step")])
    print("RESULT", json.dumps({
        "root": root, "n_recycle": runner.history["n_recycle"][4:],
        "step_s": [round(x, 4) for x in walls[4:]],
        "losses": [round(x, 4) for x in runner.history["loss"][4:]],
        "profiled_step_device_events": events}), flush=True)


def main(roots) -> int:
    if not roots:
        raise SystemExit(__doc__)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for root in roots:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        measure(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
