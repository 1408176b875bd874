"""Pass 3: mixed-precision lint (counterpart of
``repro/analysis/static/passes/precision.py``).

Three checks over the op trace:

  BF16_ACCUM          — a forward contraction (``mm`` / ``bmm`` / ``addmm``
                        / ``baddbmm``) over a *sequence* extent (r / s /
                        s_extra) whose inputs AND output are all 16-bit: it
                        accumulates in low precision exactly where error
                        grows with sequence length.  Channel contractions
                        are fine in bf16 (that IS the mixed-precision
                        policy), and only when the OUTPUT keeps a sequence
                        extent: a channel-shaped output is a weight
                        gradient.  Scope is the ``fwd`` role, as the
                        reference's.  A kernel node is not a contraction:
                        K1-K5 accumulate in fp32 inside.
  F64_PRESENT         — any float64 op output: an accidental upcast that
                        doubles bytes everywhere downstream.
  LOW_PRECISION_NORM  — ``rsqrt`` / ``sqrt`` on a 16-bit tensor: a norm's
                        variance path must upcast first (``nn.layers.
                        layernorm`` does).
"""
from __future__ import annotations

import collections

from repro_torch.analysis.static.core import Finding, PassResult, Program
from repro_torch.analysis.static.op_walk import CONTRACTIONS, iter_ops

_LOW = ("bfloat16", "float16")


def contraction_extent(rec) -> int:
    """The contracted extent of a contraction record: the last dim of its
    left matrix operand (mm / bmm: input 0; addmm / baddbmm: input 1)."""
    lhs = rec.in_shapes[1 if rec.name in ("addmm", "baddbmm") else 0][0]
    return int(lhs[-1])


def find_low_precision_contractions(trace, *, extents,
                                    require_extent_out=False) -> list:
    """Contractions over one of ``extents`` whose inputs and output are all
    16-bit; with ``require_extent_out`` the output must also keep one of
    the extents (weight-gradient products contract every one away)."""
    extents = set(int(e) for e in extents)
    hits = []
    for rec in iter_ops(trace, ("aten",)):
        if rec.name not in CONTRACTIONS or not rec.out_shapes:
            continue
        out_shape, out_dt = rec.out_shapes[0]
        if out_dt not in _LOW or not all(dt in _LOW for _, dt in rec.in_shapes):
            continue
        if require_extent_out and not any(d in extents for d in out_shape):
            continue
        k = contraction_extent(rec)
        if k in extents:
            hits.append(([k], tuple(rec.in_shapes[0][0]), tuple(out_shape),
                         out_dt, rec.path))
    return hits


def find_f64(trace) -> list:
    return [(rec.name, tuple(shape), rec.path)
            for rec in iter_ops(trace) for shape, dt in rec.out_shapes
            if dt == "float64"]


def find_low_precision_norms(trace) -> list:
    hits = []
    for rec in iter_ops(trace, ("aten",)):
        if rec.name not in ("rsqrt", "sqrt") or not rec.in_shapes:
            continue
        shape, dt = rec.in_shapes[0]
        if dt in _LOW and len(shape) >= 1:
            hits.append((rec.name, tuple(shape), rec.path))
    return hits


class PrecisionPass:
    name = "precision"

    def run(self, program: Program) -> PassResult:
        cfg = program.meta.get("cfg")
        roles = [r for r in ("fwd", "step") if r in program.traces]
        if not roles:
            return PassResult(self.name, program.name, [], skipped=True,
                              skip_reason="no trace captured")
        extents = program.meta.get("seq_extents")
        if extents is None and cfg is not None:
            extents = (cfg.n_res, cfg.n_seq, cfg.n_extra_seq)
        findings, stats = [], {}
        for role in roles:
            tr = program.traces[role]
            if extents and role == "fwd":
                dedup = {}
                for hit, in_shape, out_shape, dt, path in \
                        find_low_precision_contractions(
                            tr, extents=extents, require_extent_out=True):
                    key = (tuple(hit), in_shape, out_shape)
                    if key in dedup:
                        dedup[key]["count"] += 1
                        continue
                    dedup[key] = {"role": role, "extents": list(hit),
                                  "in_shape": list(in_shape),
                                  "out_shape": list(out_shape),
                                  "where": path, "dtype": dt, "count": 1}
                for (hit, in_shape, out_shape), det in dedup.items():
                    findings.append(Finding(
                        self.name, "BF16_ACCUM", "error", program.name,
                        f"{role}: contraction over sequence extent "
                        f"{list(hit)} with {det['dtype']} accumulation "
                        f"({in_shape} -> {out_shape}, x{det['count']}); "
                        "upcast its operands to float32",
                        detail=det,
                        detail_key={"role": role, "extents": list(hit),
                                    "out_shape": list(out_shape)}))
            for name, shape, path in find_f64(tr):
                findings.append(Finding(
                    self.name, "F64_PRESENT", "error", program.name,
                    f"{role}: {name} produces float64 {shape} — accidental "
                    "float64 upcast",
                    detail={"role": role, "prim": name, "shape": list(shape),
                            "where": path},
                    detail_key={"role": role, "prim": name}))
            for name, shape, path in find_low_precision_norms(tr):
                findings.append(Finding(
                    self.name, "LOW_PRECISION_NORM", "warning", program.name,
                    f"{role}: {name} on 16-bit tensor {shape} — variance/"
                    "norm paths should upcast to f32 first",
                    detail={"role": role, "prim": name, "shape": list(shape),
                            "where": path},
                    detail_key={"role": role, "prim": name,
                                "shape": list(shape)}))
            by_dtype = collections.Counter(
                rec.in_shapes[-1][1] for rec in iter_ops(tr, ("aten",))
                if rec.name in CONTRACTIONS and rec.in_shapes)
            stats[role] = {"n_contractions": dict(sorted(by_dtype.items()))}
        return PassResult(self.name, program.name, findings, stats=stats)
