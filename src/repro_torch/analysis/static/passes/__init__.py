"""The five analysis passes (counterpart of
``repro/analysis/static/passes``).

Each pass is a class with a ``name`` and ``run(program) -> PassResult``.
Passes never raise on a program they cannot analyze — they return a
skipped result with a reason, so one missing capture never masks the
other passes' findings.
"""
from repro_torch.analysis.static.core import Finding, PassResult, Program  # noqa: F401
from repro_torch.analysis.static.passes.collectives import CollectivesPass  # noqa: F401
from repro_torch.analysis.static.passes.materialization import MaterializationPass  # noqa: F401
from repro_torch.analysis.static.passes.precision import PrecisionPass  # noqa: F401
from repro_torch.analysis.static.passes.retrace import RetracePass  # noqa: F401
from repro_torch.analysis.static.passes.rng import RngPass  # noqa: F401
