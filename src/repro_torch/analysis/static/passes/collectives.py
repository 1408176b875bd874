"""Pass 2: collective / gradient-scaling audit (counterpart of
``repro/analysis/static/passes/collectives.py``).

Counts psum / all_gather / all_to_all per mesh axis in the forward and the
full train step, and checks that PARTIAL gradients get their completing
psum over every branch/dap sync axis.

The audit is self-calibrating, as the reference's: psum's backward is a
psum (the port's ``collectives._PSum`` as the reference's transpose), so a
step that never completes its gradients ALSO has more psums in its
backward than its forward — absolute counts prove nothing.  Program
capture therefore records a ``grad_nocomplete`` baseline — the same loss
gradient with the DP mean but without ``complete_partial_grads`` — and the
real step must carry strictly MORE psums over each sync axis than that
baseline.  Equality means the completion is missing.
"""
from __future__ import annotations

from repro_torch.analysis.overlap import collective_stats
from repro_torch.analysis.static.core import Finding, PassResult, Program
from repro_torch.analysis.static.op_walk import collective_axis_counts


def _by_axis(counts, kind="psum"):
    out = {}
    for (k, axis), n in counts.items():
        if k == kind:
            out[axis] = out.get(axis, 0) + n
    return out


def _stat(counts) -> dict:
    return {f"{k}@{a}": n for (k, a), n in sorted(counts.items())}


class CollectivesPass:
    name = "collectives"

    def run(self, program: Program) -> PassResult:
        step = program.traces.get("step")
        if step is None:
            return PassResult(self.name, program.name, [], skipped=True,
                              skip_reason="no step trace captured")
        sync_axes = tuple(program.meta.get("sync_axes", ()))
        dp_axes = tuple(program.meta.get("dp_axes", ()))
        step_counts = collective_axis_counts(step)
        stats = {"step": _stat(step_counts),
                 "step_bytes": collective_stats(step)}
        fwd = program.traces.get("fwd")
        if fwd is not None:
            stats["fwd"] = _stat(collective_axis_counts(fwd))
        findings = []

        baseline = program.traces.get("grad_nocomplete")
        if program.kind != "train":
            # completion is a gradient concept; inference psums are layer
            # collectives with nothing to complete
            sync_axes = ()
        if baseline is not None and sync_axes:
            base_counts = collective_axis_counts(baseline)
            stats["grad_nocomplete"] = _stat(base_counts)
            step_psum = _by_axis(step_counts)
            base_psum = _by_axis(base_counts)
            for axis in sync_axes:
                if step_psum.get(axis, 0) <= base_psum.get(axis, 0):
                    findings.append(Finding(
                        self.name, "GRAD_COMPLETION_MISSING", "error",
                        program.name,
                        f"step has {step_psum.get(axis, 0)} psums over sync "
                        f"axis '{axis}' — no more than the no-completion "
                        f"baseline ({base_psum.get(axis, 0)}): PARTIAL "
                        "gradients are never completed "
                        "(parallel.plan.complete_partial_grads)",
                        detail={"axis": axis,
                                "step_psum": step_psum.get(axis, 0),
                                "baseline_psum": base_psum.get(axis, 0)},
                        detail_key={"axis": axis}))
        elif sync_axes:
            return PassResult(self.name, program.name, [], skipped=True,
                              skip_reason="sync axes present but no "
                                          "grad_nocomplete baseline captured",
                              stats=stats)

        if program.kind == "train":
            step_psum = _by_axis(step_counts)
            for axis in dp_axes:
                if step_psum.get(axis, 0) == 0:
                    findings.append(Finding(
                        self.name, "DP_GRAD_REDUCE_MISSING", "error",
                        program.name,
                        f"train step has NO psum over data-parallel axis "
                        f"'{axis}': gradients are never reduced across "
                        "replicas",
                        detail={"axis": axis}, detail_key={"axis": axis}))
        return PassResult(self.name, program.name, findings, stats=stats)
