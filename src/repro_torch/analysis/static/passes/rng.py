"""Pass 4: RNG hygiene (counterpart of
``repro/analysis/static/passes/rng.py``).

The port's dropout keys are not JAX keys: a ``core.evoformer.Key`` is a
device tensor of lanes plus a host path that ``fold_in`` extends (sample,
cycle, stack, block, branch, site), and each mask is a counter-based hash
of (lanes, path).  Two draws of one (key source, path) are the same mask.
The op trace records every draw as a dropout-site node: the key's source,
its path, and the site (the port's frames, with lines, that issued it).

  KEY_REUSED          — one (key, path) drawn at two or more distinct
                        sites: correlated randomness.  Draws in the
                        backward are a ``torch.utils.checkpoint``
                        recompute (the reference's ``remat2`` exclusion)
                        and are not counted.
  RNG_LOOP_INVARIANT  — one site drawing one (key, path) twice: the site
                        ran in two iterations of a loop (per protein,
                        recycle cycle, block) that did not fold its index
                        into the key, so every iteration draws the same
                        mask.
"""
from __future__ import annotations

import collections

from repro_torch.analysis.static.core import Finding, PassResult, Program
from repro_torch.analysis.static.op_walk import iter_ops


def dropout_draws(trace):
    """``(key, site, phase)`` of every dropout draw; ``key`` names the
    source and the path, e.g. ``lanes#0(0, 0, 2, 1)``."""
    for rec in iter_ops(trace, ("dropout",)):
        yield (f"{rec.attrs['key']}{tuple(rec.attrs['key_path'])}",
               rec.attrs["site"], rec.phase)


class RngPass:
    name = "rng"

    def run(self, program: Program) -> PassResult:
        roles = [r for r in ("step", "fwd") if r in program.traces]
        if not roles:
            return PassResult(self.name, program.name, [], skipped=True,
                              skip_reason="no trace captured")
        findings, stats = [], {}
        for role in roles[:1]:   # step subsumes fwd; analyze the widest
            sites = collections.defaultdict(collections.Counter)
            recomputed = 0
            for key, site, phase in dropout_draws(program.traces[role]):
                if phase == "bwd":
                    recomputed += 1
                    continue
                sites[key][site] += 1
            for key, by_site in sorted(sites.items()):
                if len(by_site) >= 2:
                    findings.append(Finding(
                        self.name, "KEY_REUSED", "error", program.name,
                        f"{role}: key {key} drawn at {len(by_site)} sites "
                        f"— correlated randomness: {sorted(by_site)[:4]}",
                        detail={"role": role, "key": key,
                                "n_sites": len(by_site),
                                "sites": sorted(by_site)[:8]},
                        detail_key={"role": role, "key": key}))
                for site, n in sorted(by_site.items()):
                    if n >= 2:
                        findings.append(Finding(
                            self.name, "RNG_LOOP_INVARIANT", "error",
                            program.name,
                            f"{role}: key {key} drawn {n} times at one site "
                            f"({site}): every loop iteration draws the same "
                            "mask; fold the loop index into the key first",
                            detail={"role": role, "key": key, "where": site,
                                    "draws": n},
                            detail_key={"role": role, "key": key}))
            stats[role] = {"keys_sampled": len(sites),
                           "total_sample_sites": sum(
                               sum(c.values()) for c in sites.values()),
                           "recomputed_draws": recomputed}
        return PassResult(self.name, program.name, findings, stats=stats)
