"""Rank program of ``tests/test_torch_recycle_step.py``'s plan test: two
gloo ranks on the CPU serve the same requests through ``FoldEngine.serve``
with the long bucket under dap=2 and the short one under data=2, then
under one device on each rank, on measured step costs (the engine agrees
them across all its ranks).  Imports no JAX (the ranks are new
processes)."""
import torch

from repro_torch.core.model import AlphaFold2
from repro_torch.parallel.plan import ParallelPlan
from repro_torch.serve import fold_steps as fs
from repro_torch.serve.fold_engine import FoldEngine, FoldRequest
from repro_torch.serve.scheduler import VirtualClock


def engine(cfg, buckets, max_recycle, **kw):
    return FoldEngine(cfg, AlphaFold2(cfg, seed=0, device="cpu"),
                      buckets=[fs.Bucket(*b) for b in buckets],
                      micro_batch=2, max_recycle=max_recycle, tol=0.0,
                      dtype=torch.float32, device="cpu", **kw)


def requests(feats):
    return [FoldRequest(rid=i, features=f, arrival_s=0.5 * i)
            for i, f in enumerate(feats)]


def served(eng, feats):
    """The rank's results, trace and step walls of one measured serve."""
    done = eng.serve(requests(feats), clock=VirtualClock())
    rep = eng.last_report
    return {
        "results": {rid: (r.coords, r.plddt, r.n_recycles, r.finish_s)
                    for rid, r in done.items()},
        "trace": [dict(t, bucket=tuple(vars(t["bucket"]).values()))
                  for t in rep["trace"]],
        "step_wall_s": {b.n_res: w for b, w in rep["step_wall_s"].items()},
        "plans": {b.n_res: eng.plan_for(b).describe() for b in eng.buckets}}


def run(rank, world, device, inp):
    eng = engine(inp["cfg"], inp["buckets"], inp["max_recycle"],
                 plan=ParallelPlan(data=2), long_plan=ParallelPlan(dap=2))
    out = {}
    try:
        eng.serve(requests(inp["feats"]), featurize_workers=2)
    except ValueError as e:
        out["workers_error"] = str(e)
    out["data"] = served(eng, inp["feats"])
    # the short bucket on one device: every rank steps it alone
    out["replicated"] = served(
        engine(inp["cfg"], inp["buckets"], inp["max_recycle"],
               long_plan=ParallelPlan(dap=2)), inp["feats"])
    return out
