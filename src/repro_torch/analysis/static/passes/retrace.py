"""Pass 5: retrace / donation / overlap lint (counterpart of
``repro/analysis/static/passes/retrace.py``).  The reference reads the
jaxpr's input avals and the compiled HLO; the port has no compiler between
the trace and the card, so every check reads the trace and what the
capture observed, on the CPU as on the card:

  WEAK_TYPE_INPUT        — a step input that is a Python number, not a
                           tensor: a captured CUDA graph bakes it in (the
                           counterpart of a weak-typed input's retrace).
  STATIC_RECYCLE_RETRACE — more step captures than distinct recycle draws:
                           one graph per draw is the design (a CUDA graph
                           has no data-dependent loop bound), a recapture
                           of a draw is the bug.
  DONATED_NOT_ALIASED    — the step rebound a parameter or optimizer-state
                           tensor (its ``data_ptr`` changed) instead of
                           updating it in place: a captured graph would
                           keep updating the old storage, and the memory
                           doubles.
  EXPOSED_COLLECTIVE     — an overlapped-DAP program whose async gathers
                           have no compute op between start and wait in host
                           issue order (``analysis.overlap``; its overlap
                           stats are kept for every program).
"""
from __future__ import annotations

from repro_torch.analysis.static.core import Finding, PassResult, Program


class RetracePass:
    name = "retrace"

    def run(self, program: Program) -> PassResult:
        findings, stats = [], {}
        step = program.traces.get("step")
        if step is not None:
            for i, kind, dtype, shape in step.inputs:
                if kind in ("bool", "int", "float"):
                    findings.append(Finding(
                        self.name, "WEAK_TYPE_INPUT", "warning", program.name,
                        f"step input #{i} is a Python {kind}: a captured "
                        "graph bakes it in; pass a device tensor instead",
                        detail={"arg_index": i, "dtype": dtype},
                        detail_key={"arg_index": i}))
        built, draws = program.meta.get("steps_built"), program.meta.get("draws")
        if built is not None and draws is not None:
            stats["captures"] = f"{built} steps built for {draws} draws"
            if built > draws:
                findings.append(Finding(
                    self.name, "STATIC_RECYCLE_RETRACE", "error",
                    program.name,
                    f"{built} step captures for {draws} distinct recycle "
                    "draws: a draw was captured again; build one step per "
                    "draw and replay it",
                    detail={"steps_built": built, "draws": draws},
                    detail_key={}))
        rebound = program.meta.get("rebound")
        if rebound is None:
            stats["donation"] = "not applicable: the step updates no state"
        elif rebound:
            findings.append(Finding(
                self.name, "DONATED_NOT_ALIASED", "error", program.name,
                f"the step rebound {len(rebound)} state tensors instead of "
                f"updating them in place ({rebound[:4]}): a captured graph "
                "keeps writing the old storage, peak memory doubles",
                detail={"rebound": list(rebound)}, detail_key={}))
        else:
            stats["donation"] = "every state tensor updated in place"
        if step is not None:
            from repro_torch.analysis.overlap import check_async_overlap
            ok, rep = check_async_overlap(step)
            if ok is None:
                stats["overlap"] = "no async collective start/wait pairs " \
                                   "in the step"
            else:
                stats["overlap"] = (f"{rep['overlapped']}/{rep['pairs']} "
                                    "pairs overlapped")
            if ok is False and program.meta.get("expect_overlap"):
                findings.append(Finding(
                    self.name, "EXPOSED_COLLECTIVE", "error", program.name,
                    f"{len(rep['exposed'])}/{rep['pairs']} async "
                    "collective pairs have no compute inside their "
                    f"window: {rep['exposed'][:4]} — overlap_dap is not "
                    "overlapping",
                    detail=rep, detail_key={}))
        return PassResult(self.name, program.name, findings, stats=stats)
