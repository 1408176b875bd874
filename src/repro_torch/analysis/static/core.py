"""Finding / pass-result model of the port's static analyzer (the port's
copy of ``repro/analysis/static/core.py``: fingerprints are byte-identical
to the reference's for the same (pass, code, program, detail_key)).

A *pass* inspects one captured program (its op traces) and returns
``Finding``s.  Findings are identified by a stable *fingerprint* — a short
hash over (pass, code, program, salient detail) — so a committed baseline
file can waive known-accepted findings while any new fingerprint fails CI.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional

SEVERITIES = ("error", "warning", "info")


def _fingerprint(pass_name: str, code: str, program: str,
                 detail: Dict[str, Any]) -> str:
    # Only stable, identity-bearing detail keys participate; volatile ones
    # (counts, sizes that legitimately drift with config) are excluded by
    # the pass when it builds `detail_key`.
    blob = json.dumps([pass_name, code, program, detail], sort_keys=True,
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


@dataclasses.dataclass(frozen=True)
class Finding:
    pass_name: str
    code: str              # e.g. "OPM_OUTER_MATERIALIZED"
    severity: str          # error | warning | info
    program: str           # e.g. "train:dap2" / "fold:serial"
    message: str
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Subset of `detail` that identifies the finding across runs; defaults
    # to {} meaning (pass, code, program) alone identify it.
    detail_key: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r}")

    @property
    def fingerprint(self) -> str:
        return _fingerprint(self.pass_name, self.code, self.program,
                            self.detail_key)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "fingerprint": self.fingerprint,
            "pass": self.pass_name,
            "code": self.code,
            "severity": self.severity,
            "program": self.program,
            "message": self.message,
            "detail": _jsonable(self.detail),
        }


def _jsonable(obj):
    try:
        json.dumps(obj)
        return obj
    except TypeError:
        if isinstance(obj, dict):
            return {str(k): _jsonable(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [_jsonable(v) for v in obj]
        return str(obj)


@dataclasses.dataclass
class Program:
    """One captured program for the passes to chew on.

    ``traces`` maps role -> ``op_walk.OpTrace``.  Roles in use:
      * ``"step"``  — the full step (train step or fold step)
      * ``"fwd"``   — the forward of the loss (fold: the step itself)
      * ``"grad_nocomplete"`` — the loss gradient WITHOUT the completion of
        partial gradients: the null hypothesis the collectives audit
        compares the real step against (psum transposes to psum, so
        absolute backward counts prove nothing — only the delta vs this
        baseline does).
    ``meta`` carries the plan facts the passes need: sync_axes, dp_axes,
    the config, the tensors the step rebound, the captures per draw.
    """
    name: str                       # e.g. "train:dap2"
    kind: str                       # "train" | "fold" | "fixture"
    traces: Dict[str, Any] = dataclasses.field(default_factory=dict)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PassResult:
    pass_name: str
    program: str
    findings: List[Finding]
    # skipped=True when the pass could not run meaningfully here — mirrors
    # the ok=None convention of analysis.overlap.check_async_overlap.
    skipped: bool = False
    skip_reason: str = ""
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "pass": self.pass_name,
            "program": self.program,
            "skipped": self.skipped,
            "skip_reason": self.skip_reason,
            "n_findings": len(self.findings),
            "stats": _jsonable(self.stats),
            "findings": [f.to_dict() for f in self.findings],
        }


@dataclasses.dataclass
class Report:
    """Everything one lint run produced, plus the waiver verdict."""
    results: List[PassResult] = dataclasses.field(default_factory=list)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def extend(self, results: List[PassResult]) -> None:
        self.results.extend(results)

    @property
    def findings(self) -> List[Finding]:
        return [f for r in self.results for f in r.findings]

    def partition(self, waivers: Dict[str, str]):
        """Split findings into (unwaived, waived) against a
        fingerprint→reason waiver map."""
        unwaived, waived = [], []
        for f in self.findings:
            (waived if f.fingerprint in waivers else unwaived).append(f)
        return unwaived, waived

    def to_dict(self, waivers: Optional[Dict[str, str]] = None) -> Dict:
        waivers = waivers or {}
        unwaived, waived = self.partition(waivers)
        sev = {s: sum(1 for f in unwaived if f.severity == s)
               for s in SEVERITIES}
        return {
            "meta": _jsonable(self.meta),
            "summary": {
                "n_programs": len({r.program for r in self.results}),
                "n_pass_runs": len(self.results),
                "n_skipped": sum(1 for r in self.results if r.skipped),
                "n_findings": len(self.findings),
                "n_waived": len(waived),
                "n_unwaived": len(unwaived),
                "unwaived_by_severity": sev,
            },
            "waived": [
                {**f.to_dict(), "waiver_reason": waivers[f.fingerprint]}
                for f in waived
            ],
            "results": [r.to_dict() for r in self.results],
        }
