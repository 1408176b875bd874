"""Collective bytes and async-overlap verdicts over an op trace
(counterpart of ``repro/analysis/hlo.py``, which parses compiled HLO).

The port's step runs eagerly: the host issues its ops in program order, so
the trace's record order is the issue order, and the ops recorded between
an async gather's start and its wait are the work issued inside the
collective's latency.
"""
from __future__ import annotations

from collections import defaultdict

from repro_torch.analysis.static.op_walk import iter_ops

# ops that neither compute nor move meaningful data: a start/wait pair
# separated only by these is NOT overlapped
_PASSTHROUGH_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t",
    "expand", "squeeze", "unsqueeze", "alias", "as_strided", "detach",
    "slice", "select", "split", "split_with_sizes", "chunk", "unbind",
    "empty", "empty_like", "empty_strided", "new_empty", "_to_copy",
    "copy_", "clone", "contiguous", "lift_fresh", "_local_scalar_dense",
})


def collective_stats(trace) -> dict:
    """{kind: {"count", "bytes"}} of the collectives issued (an async gather
    counts once, at its start; bytes are each collective's output)."""
    out: dict = defaultdict(lambda: {"count": 0, "bytes": 0})
    for rec in iter_ops(trace, ("collective",)):
        if rec.attrs.get("event") == "wait":
            continue
        out[rec.name]["count"] += 1
        out[rec.name]["bytes"] += rec.attrs["bytes"]
    return dict(out)


def _is_compute(rec) -> bool:
    if rec.kind == "kernel":
        return True
    return rec.kind == "aten" and rec.name not in _PASSTHROUGH_OPS


def async_collective_gaps(trace, kinds=("all_gather",)) -> list:
    """For every async start / wait pair of the given kinds: the records
    issued between them.  One dict per pair: ``{"name", "kind", "gap_ops",
    "compute_ops", "compute_opnames"}`` — ``compute_ops`` counts kernel
    nodes and aten ops that are neither views nor copies (the overlap
    evidence); other collectives and dropout sites are not compute."""
    kinds = tuple(kinds)
    open_pairs: dict = {}
    out = []
    for rec in trace.records:
        event = rec.attrs.get("event") if rec.kind == "collective" else None
        if event == "start" and rec.name in kinds:
            open_pairs[rec.attrs["pair"]] = {
                "name": f"{rec.name}#{rec.attrs['pair']}", "kind": rec.name,
                "ops": []}
            continue
        if event == "wait" and rec.attrs.get("pair") in open_pairs:
            pair = open_pairs.pop(rec.attrs["pair"])
            gap = pair.pop("ops")
            pair["gap_ops"] = len(gap)
            pair["compute_opnames"] = [r.name for r in gap if _is_compute(r)]
            pair["compute_ops"] = len(pair["compute_opnames"])
            out.append(pair)
            continue
        for pair in open_pairs.values():
            pair["ops"].append(rec)
    return out


def check_async_overlap(trace, *, kinds=("all_gather",),
                        min_compute: int = 1):
    """Are the async collectives hidden behind compute?  ``(ok, report)``.
    ``ok`` is None when the trace holds NO async pair of the given kinds
    (one device, or a schedule without prefetch): nothing to check.
    Otherwise ok is True iff every pair has at least ``min_compute``
    compute ops inside its window."""
    pairs = async_collective_gaps(trace, kinds=kinds)
    if not pairs:
        return None, {"pairs": 0, "detail": []}
    bad = [p for p in pairs if p["compute_ops"] < min_compute]
    report = {
        "pairs": len(pairs),
        "overlapped": len(pairs) - len(bad),
        "exposed": [p["name"] for p in bad],
        "detail": [{k: p[k] for k in
                    ("name", "kind", "gap_ops", "compute_ops")}
                   for p in pairs],
    }
    return not bad, report
