"""Static-analysis pass suite over op traces of the port's real steps
(counterpart of ``repro/analysis/static``).

Five passes, each generalizing a bug class the reference hit:

  materialization — the kernels' memory promise: no (h, S, S) score tensor,
                    no (r, r, 2·c_mul) gated pair, no (r, r, c_opm²) outer
                    product outside a kernel node
  collectives     — per-mesh-axis psum / all_gather / all_to_all audit with
                    a self-calibrating gradient-completion check
  precision       — bf16 contractions without fp32 accumulation, stray f64,
                    low-precision norms
  rng             — dropout keys drawn at two sites / not folded per loop
                    iteration
  retrace         — Python-number step inputs, recaptures beyond one per
                    draw, state rebound instead of updated in place, exposed
                    async collectives

Run them all: ``python -m repro_torch.analysis.lint``.  Waivers live in
``src/repro_torch/analysis/lint_baseline.json``; any finding whose
fingerprint is not waived fails the run.
"""
from repro_torch.analysis.static.core import (  # noqa: F401
    Finding, PassResult, Program, Report,
)
from repro_torch.analysis.static import op_walk  # noqa: F401


def all_passes():
    """The full pass suite, in the reference's order (import deferred: the
    collectives pass imports ``analysis.overlap``, which imports this
    package's ``op_walk``)."""
    from repro_torch.analysis.static.passes import (
        CollectivesPass, MaterializationPass, PrecisionPass, RetracePass,
        RngPass,
    )
    return [MaterializationPass(), CollectivesPass(), PrecisionPass(),
            RngPass(), RetracePass()]
