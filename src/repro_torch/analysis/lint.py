"""Static-analysis gate of the port: trace the real train and fold steps of
every ParallelPlan and run the pass suite over the traces (counterpart of
``repro/analysis/lint.py``).

    python -m repro_torch.analysis.lint                    # full matrix, gated, on the card
    python -m repro_torch.analysis.lint --device cpu       # the same on the CPU
    python -m repro_torch.analysis.lint --only train:dap2  # substring filter
    python -m repro_torch.analysis.lint --list             # show matrix + passes
    python -m repro_torch.analysis.lint --write-baseline   # accept current findings

``--devices`` rank processes (default 4, which the hybrid needs) capture
the matrix together: every rank builds every plan's meshes in the same
order, and one copy of each plan captures its program, the copies taking
turns (``program.capture_all``).  Ranks on the card share it over gloo.
Findings of all ranks are merged by fingerprint (the ranks that found one
go into its ``detail``).  The reference's ``--hlo`` has no
counterpart: the donation and overlap checks always run, from the trace.

The gate: every finding's fingerprint is looked up in the baseline
(``src/repro_torch/analysis/lint_baseline.json``).  Unwaived findings exit
1 — a new finding fails until it is fixed or waived with a written reason.
Stale waivers (fingerprints no run produces any more) are reported.  The
full report goes to ``build/repro_torch_lint/report.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_BASELINE = Path(__file__).resolve().parent / "lint_baseline.json"
DEFAULT_REPORT = _REPO_ROOT / "build" / "repro_torch_lint" / "report.json"


def load_baseline(path: Path) -> dict:
    if not path.exists():
        return {"version": 1, "waivers": {}}
    data = json.loads(path.read_text())
    if data.get("version") != 1:
        raise SystemExit(f"lint: unsupported baseline version in {path}")
    return data


def run_passes(programs) -> list:
    """[(program name, [PassResult per pass])] of this rank."""
    from repro_torch.analysis.static import all_passes
    passes = all_passes()
    return [(prog.name, [p.run(prog) for p in passes]) for prog in programs]


def merge_ranks(per_rank: list) -> list:
    """One PassResult per (program, pass) from every rank's results (a list
    of (program name, results) per rank, of the programs it captured):
    findings merged by fingerprint, with the ranks that found each in its
    ``detail``; stats are those of the first rank that captured the
    program, plus ``by_rank`` for the ranks whose stats differ; skipped if
    any rank skipped."""
    from repro_torch.analysis.static.core import Finding, PassResult
    out = []
    captured = [dict(results) for results in per_rank]
    names = dict.fromkeys(name for results in per_rank for name, _ in results)
    for name in names:
        have = [(rank, got[name]) for rank, got in enumerate(captured)
                if name in got]
        for j, res in enumerate(have[0][1]):
            found, ranks, stats_by_rank, skipped = {}, {}, {}, None
            for rank, results in have:
                r = results[j]
                if r.stats != res.stats:
                    stats_by_rank[rank] = r.stats
                if r.skipped and skipped is None:
                    skipped = r.skip_reason
                for f in r.findings:
                    found.setdefault(f.fingerprint, f)
                    ranks.setdefault(f.fingerprint, []).append(rank)
            findings = [Finding(f.pass_name, f.code, f.severity, f.program,
                                f.message, {**f.detail, "ranks": ranks[fp]},
                                f.detail_key)
                        for fp, f in found.items()]
            stats = dict(res.stats)
            if stats_by_rank:
                stats["by_rank"] = stats_by_rank
            out.append(PassResult(res.pass_name, name, findings,
                                  skipped=skipped is not None,
                                  skip_reason=skipped or "", stats=stats))
    return out


def _lint_rank(rank, world, device, only):
    from repro_torch.analysis.static.program import capture_all
    return run_passes(capture_all(only=only, device=device))


def describe_results(results) -> list:
    """One line per program: clean or its finding count, and skips."""
    lines, by_prog = [], {}
    for r in results:
        by_prog.setdefault(r.program, []).append(r)
    for name, rs in by_prog.items():
        n = sum(len(r.findings) for r in rs)
        lines.append(f"  {name:20s} {'clean' if n == 0 else f'{n} findings'}"
                     + "".join(f" [{r.pass_name}: skipped — {r.skip_reason}]"
                               for r in rs if r.skipped))
    return lines


def run_lint(*, only=None, devices: int = 4, device_type=None,
             timeout_s: float = 900.0):
    """Capture and check the matrix over ``devices`` rank processes on
    ``device_type`` (None: the card); returns the merged ``Report``."""
    import torch
    from repro_torch.analysis.static.core import Report
    from repro_torch.analysis.static.program import (fold_plan_matrix,
                                                     train_plan_matrix)
    from repro_torch.parallel import ranks

    device_type = ranks.resolve_device_type(device_type)
    if device_type == "cuda":
        from repro_torch.kernels import build
        build.build_all()       # once, before the ranks start
    # one intra-op thread per CPU rank: the lint config's ops are small,
    # and the ranks' Python is what takes the time
    per_rank = ranks.spawn(
        _lint_rank, devices, only, device_type=device_type,
        backend="gloo", timeout_s=timeout_s,
        threads=1 if device_type == "cpu" else 0)
    report = Report(meta={"torch": torch.__version__, "n_ranks": devices,
                          "device": device_type, "only": only or ""})
    order = [f"train:{n}" for n, _, _ in train_plan_matrix()] + \
        [f"fold:{n}" for n, _, _ in fold_plan_matrix()]
    report.extend(sorted(merge_ranks(per_rank),
                         key=lambda r: order.index(r.program)))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="static analyzer over the ParallelPlan program matrix")
    ap.add_argument("--only", default=None,
                    help="substring filter on program names "
                         "(e.g. 'train:dap2', 'fold:')")
    ap.add_argument("--report", type=Path, default=DEFAULT_REPORT,
                    help="where to write the JSON report")
    ap.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE,
                    help="waiver file (fingerprint -> reason)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="waive all current findings (new entries get a "
                         "placeholder reason to fill in) and rewrite the "
                         "baseline")
    ap.add_argument("--list", action="store_true",
                    help="list the program matrix and passes, then exit")
    ap.add_argument("--devices", type=int, default=4,
                    help="rank processes that capture the matrix (default 4; "
                         "the hybrid plan needs 4)")
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="where the ranks run the steps (default: cuda, "
                         "which must exist)")
    ap.add_argument("--rank-timeout", type=float, default=900.0,
                    help="seconds the ranks may take")
    args = ap.parse_args(argv)

    if args.list:
        from repro_torch.analysis.static import all_passes
        from repro_torch.analysis.static.program import (fold_plan_matrix,
                                                         train_plan_matrix)
        print("programs:")
        for name, plan, clip in train_plan_matrix():
            extra = f" per_sample_clip={clip}" if clip is not None else ""
            print(f"  train:{name:12s} {plan.describe()}{extra}")
        for name, plan, dtype in fold_plan_matrix():
            print(f"  fold:{name:13s} {plan.describe()} dtype={dtype}")
        print("passes:")
        for p in all_passes():
            print(f"  {p.name}")
        return 0

    baseline = load_baseline(args.baseline)
    waivers = dict(baseline.get("waivers", {}))

    report = run_lint(only=args.only, devices=args.devices,
                      device_type=args.device, timeout_s=args.rank_timeout)
    for line in describe_results(report.results):
        print(line, file=sys.stderr)
    unwaived, waived = report.partition(waivers)

    live = {f.fingerprint for f in report.findings}
    stale = sorted(set(waivers) - live)
    # A filtered run sees only a slice of the matrix — fingerprints from
    # other programs are not stale, just out of scope.
    if stale and not args.only:
        for fp in stale:
            print(f"lint: stale waiver {fp}: {waivers[fp]!r} "
                  "(no program produces it any more)", file=sys.stderr)

    if args.write_baseline:
        new = {f.fingerprint: waivers.get(
                   f.fingerprint, f"UNREVIEWED: {f.code} in {f.program} — "
                                  "replace with a real justification")
               for f in report.findings}
        if not args.only:   # full run: drop stale entries
            waivers = new
        else:               # partial run: merge, keep out-of-scope waivers
            waivers.update(new)
        args.baseline.write_text(json.dumps(
            {"version": 1, "waivers": waivers}, indent=2, sort_keys=True)
            + "\n")
        print(f"lint: wrote {len(waivers)} waivers to {args.baseline}",
              file=sys.stderr)
        unwaived, waived = report.partition(waivers)

    args.report.parent.mkdir(parents=True, exist_ok=True)
    args.report.write_text(json.dumps(report.to_dict(waivers), indent=2,
                                      sort_keys=True) + "\n")

    s = report.to_dict(waivers)["summary"]
    print(f"lint: {s['n_programs']} programs, {s['n_pass_runs']} pass runs "
          f"({s['n_skipped']} skipped), {s['n_findings']} findings "
          f"({s['n_waived']} waived, {s['n_unwaived']} unwaived)")
    for f in unwaived:
        print(f"  UNWAIVED [{f.severity}] {f.fingerprint} "
              f"{f.pass_name}/{f.code} {f.program}: {f.message}")
    if unwaived:
        print("lint: FAIL — fix the findings above or waive them with a "
              f"reason in {args.baseline.name}", file=sys.stderr)
        return 1
    print("lint: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
