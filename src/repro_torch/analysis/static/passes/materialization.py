"""Pass 1: materialization lint — the kernels' memory promise (counterpart
of ``repro/analysis/static/passes/materialization.py``).

Walk every op output of the trace (a kernel node is one opaque op, so what
a kernel holds in its registers and shared memory never shows) and assert

  * no ``(r, r, c_opm^2)`` outer-product tensor (fused OPM)
  * no ``(r, r, 2*c_mul)`` gated-projection pair (the triangle kernel K3)
  * no full ``(..., h, S, S)`` attention-score tensor: the reference arms
    this for its ``chunked`` attention at ``attention_chunk < S``; the
    port's ``evo_pallas`` attention (K1 / K2) makes the same promise with
    no chunk at all, so for it every extent is armed

The element-count thresholds come from the config under analysis, so the
lint runs a dedicated config whose thresholds sit strictly above every
legitimate intermediate (``program.lint_config``).
"""
from __future__ import annotations

from repro_torch.analysis.static.core import Finding, PassResult, Program
from repro_torch.analysis.static.op_walk import (iter_out_shapes, op_elems,
                                                 peak_op_elems)


def _opm_shape(c):
    """The outer-product tensor ends in (c, c) or a flattened c*c."""
    def match(shape):
        return (len(shape) >= 2 and shape[-2:] == (c, c)) or \
               (len(shape) >= 1 and shape[-1] == c * c)
    return match


def _tri_shape(c_mul):
    """The gated-projection pair ends in the concatenated 2*c_mul channel."""
    def match(shape):
        return len(shape) >= 1 and shape[-1] == 2 * c_mul
    return match


def size_thresholds(cfg) -> list:
    """[(label, threshold_elems, shape_match, code)] for every fused-impl
    guarantee the config promises (the reference's, label for label).
    Only impls that make the promise are checked; ``shape_match`` pins the
    finding to tensors that instantiate the guarantee's channel layout, so
    an unrelated large intermediate never cross-fires every threshold."""
    out = []
    r = cfg.n_res
    for sname, e in (("evoformer", cfg.evoformer), ("extra", cfg.extra)):
        if e.opm_impl == "fused":
            out.append((f"{sname}.opm_outer",
                        r * r * e.c_hidden_opm ** 2,
                        _opm_shape(e.c_hidden_opm),
                        "OPM_OUTER_MATERIALIZED"))
        if e.tri_mult_impl in ("chunked", "pallas"):
            out.append((f"{sname}.tri_gated_pair",
                        r * r * 2 * e.c_hidden_mul,
                        _tri_shape(e.c_hidden_mul),
                        "TRIMULT_PAIR_MATERIALIZED"))
    return out


def find_oversized_ops(trace, thresholds) -> list:
    """All (label, code, shape, elems, path) where an op output meets or
    exceeds a threshold AND matches that guarantee's channel layout; deduped
    by (code, shape)."""
    hits = {}
    for shape, _, rec in iter_out_shapes(trace):
        n = op_elems(shape)
        for label, thr, match, code in thresholds:
            if n >= thr and match(shape):
                key = (code, shape)
                if key not in hits:
                    hits[key] = (label, code, shape, n, rec.path)
    return list(hits.values())


def find_full_score_ops(trace, *, heads, chunk_by_extent) -> list:
    """Full attention-score tensors: contraction outputs (``mm`` / ``bmm``
    / ``addmm`` / ``baddbmm``, and the views ``einsum`` puts after them)
    shaped ``(..., h, S, S)`` with h a known head count and S an armed
    extent larger than its chunk.  A kernel node is not a contraction, and
    the legitimate ``(h, r, r)`` pair bias is a projection moved into place
    outside einsum, so neither reads as scores."""
    heads = set(heads)
    hits = {}
    for shape, _, rec in iter_out_shapes(trace):
        if not rec.contraction or len(shape) < 3:
            continue
        h, q, k = shape[-3:]
        if h not in heads or q != k or k not in chunk_by_extent:
            continue
        if k <= chunk_by_extent[k]:
            continue   # chunk covers the whole extent: full scores are fine
        if shape not in hits:
            hits[shape] = (shape, op_elems(shape), rec.path)
    return list(hits.values())


def attention_chunk_map(cfg) -> dict:
    """extent -> allowed query chunk for every (stack, axis) attention the
    config promises not to materialize: ``chunked`` at its
    ``attention_chunk``, the port's ``evo_pallas`` kernels at 0 (no full
    score tensor of any extent)."""
    out = {}
    for e, s_extent in ((cfg.evoformer, cfg.n_seq),
                        (cfg.extra, cfg.n_extra_seq)):
        if e.attention_impl == "chunked":
            chunk = e.attention_chunk
        elif e.attention_impl == "evo_pallas":
            chunk = 0
        else:
            continue
        for extent in (cfg.n_res, s_extent):
            # two stacks may share an extent: keep the smaller chunk (stricter)
            out[extent] = min(out.get(extent, chunk), chunk)
    return out


class MaterializationPass:
    name = "materialization"

    def run(self, program: Program) -> PassResult:
        cfg = program.meta.get("cfg")
        roles = [r for r in ("fwd", "step") if r in program.traces]
        if cfg is None or not roles:
            return PassResult(self.name, program.name, [], skipped=True,
                              skip_reason="no cfg/trace captured")
        thresholds = size_thresholds(cfg)
        heads = {cfg.evoformer.n_head_msa, cfg.evoformer.n_head_pair,
                 cfg.extra.n_head_msa, cfg.extra.n_head_pair}
        chunks = attention_chunk_map(cfg)
        findings, peaks = [], {}
        for role in roles:
            tr = program.traces[role]
            for label, code, shape, n, path in find_oversized_ops(
                    tr, thresholds):
                findings.append(Finding(
                    self.name, code, "error", program.name,
                    f"{role}: intermediate {shape} ({n} elems) reaches the "
                    f"{label} bound the fused impl promises to avoid",
                    detail={"role": role, "shape": list(shape), "elems": n,
                            "where": path, "guarantee": label},
                    detail_key={"role": role, "guarantee": label}))
            for shape, n, path in find_full_score_ops(
                    tr, heads=heads, chunk_by_extent=chunks):
                findings.append(Finding(
                    self.name, "FULL_ATTENTION_SCORES", "error", program.name,
                    f"{role}: full attention-score tensor {shape} "
                    f"materialized despite attention chunk "
                    f"{chunks[shape[-1]]}",
                    detail={"role": role, "shape": list(shape), "elems": n,
                            "where": path},
                    detail_key={"role": role, "extent": shape[-1]}))
            peaks[role] = peak_op_elems(tr)
        return PassResult(self.name, program.name, findings,
                          stats={"peak_op_elems": peaks,
                                 "thresholds": {lbl: thr for lbl, thr, _, _ in
                                                thresholds}})
