"""The port's static analyzer (``repro_torch.analysis``) on known-bad
fixtures and against the reference's pure modules.

* Fixtures: one case per fixture test of ``tests/test_lint.py`` (named in
  each case), as an op trace of torch code.  Both halves are checked: the
  bug fires its code, and the fixed twin is clean (no finding of that
  pass).  The collective cases run in a one-rank gloo world of this
  process, with stand-in axes: a psum over a stand-in of extent 2 reduces
  over the one rank, which is all the audit needs (it counts).
* Parity: fingerprints, report summaries, the materialization thresholds
  of the lint config, the plan matrices and the baseline loader equal the
  reference's; the fold programs give the reference's findings (none) and
  peak (61440 elements), and with the kernel nodes switched off the plain
  versions' score tensor and gated pair fire.
* The gate: ``python -m repro_torch.analysis.lint --device cpu`` over four
  rank processes, and the train launcher's ``--lint`` under torchrun (two
  ranks).  Both subprocesses start with the module (an autouse fixture)
  and run while the in-process tests do; the last two tests wait for them.
* The trainer's ``hlo_check``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist

import torch_threads  # noqa: F401  (one intra-op thread)
from repro_torch.analysis import lint
from repro_torch.analysis.static import op_walk
from repro_torch.analysis.static.core import (Finding, PassResult, Program,
                                              Report)
from repro_torch.analysis.static.passes import (CollectivesPass,
                                                MaterializationPass,
                                                PrecisionPass, RetracePass,
                                                RngPass)
from repro_torch.analysis.static.program import lint_config, state_tensors
from repro_torch.core import evoformer as evo
from repro_torch.kernels import ops as kops
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import ranks

CFG = lint_config()
R, S = CFG.n_res, CFG.n_seq
H = CFG.evoformer.n_head_msa
ROOT = Path(__file__).resolve().parents[1]
GATE_TIMEOUT_S = 400


@pytest.fixture(scope="module", autouse=True)
def gate_runs(tmp_path_factory):
    """The two subprocesses of the gate, started before the first test:
    the lint CLI over four CPU ranks and a two-rank torchrun launch with
    ``--lint``.  Yields {name: (Popen, report path)}; kills what is still
    running at the end."""
    tmp = tmp_path_factory.mktemp("lint_gate")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    report = tmp / "report.json"
    procs = {
        "cli": (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.analysis.lint", "--device",
             "cpu", "--report", str(report), "--rank-timeout",
             str(GATE_TIMEOUT_S)], cwd=tmp, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), report),
        "torchrun": (subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", "2", "--master-port",
             str(ranks.free_port()), "-m", "repro_torch.launch.train",
             "--device", "cpu", "--af2", "tiny", "--steps", "1", "--batch",
             "1", "--bp", "2", "--lint", "--ema", "0"], cwd=tmp,
            env={**env, "OMP_NUM_THREADS": "1"}, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), None)}
    yield procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _finish(proc) -> tuple:
    out, err = proc.communicate(timeout=GATE_TIMEOUT_S)
    return proc.returncode, out, err


@dataclasses.dataclass(frozen=True)
class StandIn:
    """An ``Axis`` stand-in over the one-rank world: ``size`` as given
    (psum skips an axis of extent 1, a gather needs the group's size)."""
    name: str
    size: int = 2
    index: int = 0

    @property
    def group(self):
        return dist.group.WORLD


@pytest.fixture(scope="module")
def world1():
    """A one-rank gloo world in this process, torn down after."""
    mine = not dist.is_initialized()
    if mine:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{ranks.free_port()}",
            rank=0, world_size=1)
    yield
    if mine:
        dist.destroy_process_group()


def _g(*shape, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=gen).to(dtype)


def _trace(fn, *args, **kw):
    return op_walk.capture(fn, *args, **kw)[0]


def _prog(name, traces, kind="fixture", **meta):
    return Program(name=f"fixture:{name}", kind=kind, traces=traces,
                   meta=meta)


# ---------------------------------------------------------------------------
# The cases: (reference test, pass, code, bug program, twin program)
# ---------------------------------------------------------------------------

def case_unfused_opm():
    c = CFG.evoformer.c_hidden_opm
    a, b = _g(S, R, c), _g(S, R, c, seed=1)

    def naive(a, b):
        outer = torch.einsum("sic,sjd->ijcd", a, b) / S      # (r, r, c, c)
        return outer.reshape(R, R, -1).sum(-1)

    w, bo = _g(c * c, CFG.c_z), _g(CFG.c_z)
    fused = lambda a, b: evo.opm_contract(a, b, w, bo, float(S),
                                          torch.float32, row_chunk=4)
    bug = _prog("unfused_opm", {"fwd": _trace(naive, a, b)}, cfg=CFG)
    res = MaterializationPass().run(bug)
    # the shape guard keeps it from cross-firing the tri-mult bound
    assert "TRIMULT_PAIR_MATERIALIZED" not in {f.code for f in res.findings}
    return (bug, _prog("fused_opm", {"fwd": _trace(fused, a, b)}, cfg=CFG))


def _tri_args(c_z=CFG.c_z, c_mul=CFG.evoformer.c_hidden_mul):
    x = _g(R, R, c_z)
    return (x, x, x, _g(c_z, 2 * c_mul, seed=1), _g(2 * c_mul, seed=2),
            _g(c_z, 2 * c_mul, seed=3), _g(2 * c_mul, seed=4),
            torch.ones(c_mul), torch.zeros(c_mul), _g(c_mul, c_z, seed=5),
            _g(c_z, seed=6), _g(c_z, c_z, seed=7), _g(c_z, seed=8))


def case_trimult_gated_pair():
    c_mul = CFG.evoformer.c_hidden_mul
    a, b, ga, gb = (_g(R, R, c_mul, seed=i) for i in range(4))

    def gated_pair(a, b, ga, gb):
        return torch.cat([a * ga, b * gb], -1)              # (r, r, 2*c_mul)

    return (_prog("tri_pair", {"fwd": _trace(gated_pair, a, b, ga, gb)},
                  cfg=CFG),
            _prog("tri_kernel", {"fwd": _trace(kops.triangle_mult,
                                               *_tri_args())}, cfg=CFG))


def _naive_attention(q, k, v):
    scores = torch.einsum("hqc,hkc->hqk", q, k)              # (h, r, r)
    return torch.einsum("hqk,khc->qhc", torch.softmax(scores, -1), v)


def case_unchunked_attention_scores():
    """The plain attention's (h, r, r) scores fire; the K1 kernel node with
    its pair bias (a projection moved into place) stays clean."""
    q, k = _g(H, R, 8), _g(H, R, 8, seed=1)
    v = _g(R, H, 8, seed=2)
    p = evo.GatedAttention(CFG.c_m, 8, H, c_bias_in=CFG.c_z,
                           generator=torch.Generator().manual_seed(0))

    def kernel(x, z):
        return evo.gated_attention(p, x, n_head=H, c_hidden=8, bias_input=z,
                                   attention_impl="evo_pallas")

    x, z = _g(S, R, CFG.c_m, seed=3), _g(R, R, CFG.c_z, seed=4)
    with torch.no_grad():
        twin = _trace(kernel, x, z)
    return (_prog("full_scores", {"fwd": _trace(_naive_attention, q, k, v)},
                  cfg=CFG),
            _prog("kernel_scores", {"fwd": twin}, cfg=CFG))


def case_chunked_attention_slab():
    """Under the reference's chunked impl (chunk 4), a (h, 4, r) slab is
    clean and the full (h, r, r) scores fire."""
    ev = dataclasses.replace(CFG.evoformer, attention_impl="chunked")
    cfg = dataclasses.replace(CFG, evoformer=ev, extra=ev)
    q, k = _g(H, R, 8), _g(H, R, 8, seed=1)
    v = _g(R, H, 8, seed=2)
    slab = lambda q, k: torch.einsum("hqc,hkc->hqk", q, k)   # (h, 4, r)
    return (_prog("full_scores", {"fwd": _trace(_naive_attention, q, k, v)},
                  cfg=cfg),
            _prog("chunk_slab", {"fwd": _trace(slab, q[:, :4], k)}, cfg=cfg))


def case_grad_completion():
    bp = StandIn("bp")
    w = _g(8).requires_grad_(True)
    x = _g(8, seed=1)

    def buggy(w, x):                    # PARTIAL gradient, never completed
        loss = coll.psum((w * x).sum(), bp)
        return torch.autograd.grad(loss, w)[0]

    def fixed(w, x):
        return coll.psum_tree({"w": buggy(w, x)}, (bp,))["w"]

    base = _trace(buggy, w, x, ops=False)
    meta = dict(sync_axes=("bp",), dp_axes=())
    return (_prog("completion", {"step": _trace(buggy, w, x),
                                 "grad_nocomplete": base}, "train", **meta),
            _prog("completed", {"step": _trace(fixed, w, x),
                                "grad_nocomplete": base}, "train", **meta))


def case_dp_reduce_missing():
    data = StandIn("data")
    g = _g(4)
    return (_prog("no_dp_reduce", {"step": _trace(lambda g: g * 2.0, g)},
                  "train", sync_axes=(), dp_axes=("data",)),
            _prog("dp_reduce", {"step": _trace(
                lambda g: coll.pmean_tree({"g": g}, (data,))["g"], g)},
                "train", sync_axes=(), dp_axes=("data",)))


def _weighted_sum(w, v):              # contract k=r, output keeps q=r
    return torch.einsum("hqk,khc->qhc", w, v)


def _bf16_dot():
    w = _g(H, R, R, dtype=torch.bfloat16)
    v = _g(R, H, 8, dtype=torch.bfloat16, seed=1)
    return (_prog("bf16_dot", {"fwd": _trace(_weighted_sum, w, v)},
                  seq_extents=(R,)), w, v)


def case_bf16_accumulation():
    """The bf16 contraction fires; the K1 kernel node (fp32 accumulation
    inside) at bf16 is clean."""
    bug, _, _ = _bf16_dot()
    qkv = [_g(S, R, H, 8, dtype=torch.bfloat16, seed=i) for i in range(4)]
    bias = _g(H, R, R, dtype=torch.bfloat16, seed=5)
    return bug, _prog("bf16_kernel", {"fwd": _trace(
        kops.evo_attention, *qkv[:3], bias, qkv[3])}, seq_extents=(R, S))


def case_weight_gradient_dot():
    bug, _, _ = _bf16_dot()
    act = _g(R, 8, dtype=torch.bfloat16)
    cot = _g(R, 16, dtype=torch.bfloat16, seed=1)
    wgrad = lambda a, c: torch.einsum("rc,rd->cd", a, c)
    return bug, _prog("wgrad", {"fwd": _trace(wgrad, act, cot)},
                      seq_extents=(R,))


def case_f32_accumulation():
    bug, w, v = _bf16_dot()
    f32 = lambda w, v: _weighted_sum(w.float(), v.float()).to(w.dtype)
    return bug, _prog("f32_accum", {"fwd": _trace(f32, w, v)},
                      seq_extents=(R,))


def case_f64():
    x = _g(4)
    return (_prog("f64", {"fwd": _trace(lambda x: (x.double() * 2.0).sum(),
                                        x)}, seq_extents=()),
            _prog("f32", {"fwd": _trace(lambda x: (x * 2.0).sum(), x)},
                  seq_extents=()))


def case_low_precision_norm():
    from repro_torch.nn.layers import LayerNorm, layernorm

    def handrolled_ln(x):               # no fp32 upcast before rsqrt
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-5)

    x = _g(4, 8, dtype=torch.bfloat16)
    ln = LayerNorm(8)
    with torch.no_grad():
        twin = _trace(layernorm, ln, x)
    return (_prog("bf16_ln", {"fwd": _trace(handrolled_ln, x)},
                  seq_extents=()),
            _prog("repo_ln", {"fwd": twin}, seq_extents=()))


def _drop(x, rng):
    return evo.shared_dropout(x, 0.25, shared_axis=0, rng=rng,
                              deterministic=False)


def _key(*words):
    return evo.dropout_key(words or (0,), "cpu")


def case_reused_dropout_key():
    x, key = _g(4, 6), _key()

    def reuse(x, key):
        keep = _drop(x, key)                       # site 1
        return keep + _drop(x, key)                # site 2: the same key

    def folded(x, key):
        return _drop(x, evo.fold_in(key, 0)) + _drop(x, evo.fold_in(key, 1))

    return (_prog("key_reuse", {"step": _trace(reuse, x, key)}),
            _prog("key_fold", {"step": _trace(folded, x, key)}))


def case_split_keys():
    x = _g(4, 6)

    def reuse(x, key):
        keep = _drop(x, key)
        return keep + _drop(x, key)

    def proper(x, k1, k2):
        return _drop(x, k1) + _drop(x, k2)

    return (_prog("key_reuse", {"step": _trace(reuse, x, _key())}),
            _prog("key_split", {"step": _trace(proper, x, _key(0, 1),
                                               _key(0, 2))}))


def _loop(x, key, *, fold):
    out = x
    for i in range(3):
        out = out + _drop(x, evo.fold_in(key, i) if fold else key)
    return out


def case_loop_invariant_key():
    x, key = _g(4, 6), _key()
    return (_prog("loop_invariant", {"step": _trace(_loop, x, key,
                                                    fold=False)}),
            _prog("loop_folded", {"step": _trace(_loop, x, key, fold=True)}))


def case_folded_loop_key():
    """The port's Evoformer stack (two blocks, each folding its index,
    ``remat="block"``) through its backward: the recompute's draws in the
    backward are the checkpoint's, not a reuse."""
    from repro_torch.core.model import AlphaFold2, evoformer_stack
    model = AlphaFold2(CFG, seed=0, device="cpu")
    msa = _g(S, R, CFG.c_m).requires_grad_(True)
    z = _g(R, R, CFG.c_z, seed=1)

    def stack(msa, z, key):
        m, zz = evoformer_stack(model.evoformer, CFG.evoformer, msa, z,
                                rng=key, deterministic=False, remat="block")
        (m.sum() + zz.sum()).backward()

    x, key = _g(4, 6), _key()
    twin = _trace(stack, msa, z, key)
    assert any(r.phase == "bwd" for r in op_walk.iter_ops(twin, ("dropout",)))
    return (_prog("loop_invariant", {"step": _trace(_loop, x, key,
                                                    fold=False)}),
            _prog("stack_folded", {"step": twin}))


def case_weak_type_input():
    return (_prog("weak", {"step": _trace(lambda x: x + 1, 2.0)}),
            _prog("strong", {"step": _trace(lambda x: x + 1,
                                            torch.tensor(2.0))}))


def case_static_recycle_retrace():
    step = _trace(lambda x: x, torch.tensor(0.0))
    return (_prog("recaptured", {"step": step}, steps_built=2, draws=1),
            _prog("per_draw", {"step": step}, steps_built=2, draws=2))


def case_donated_not_aliased():
    """A step that rebinds a parameter's storage (``p.data = ...``)
    instead of updating it in place, as capture_train detects it."""
    lin = torch.nn.Linear(4, 4)
    state = {"params": lin, "opt": type("Opt", (), {"_fields": ()})()}

    def rebound(step_fn):
        before = {k: t.data_ptr() for k, t in state_tensors(state).items()}
        trace = _trace(step_fn)
        after = state_tensors(state)
        return trace, sorted(k for k, t in after.items()
                             if t.data_ptr() != before[k])

    def rebind():
        lin.weight.data = lin.weight.data * 0.5

    @torch.no_grad()
    def in_place():
        lin.weight.mul_(0.5)

    bug_trace, bug_rebound = rebound(rebind)
    twin_trace, twin_rebound = rebound(in_place)
    assert bug_rebound == ["params.weight"] and twin_rebound == []
    return (_prog("donation_dropped", {"step": bug_trace},
                  rebound=bug_rebound),
            _prog("donation_kept", {"step": twin_trace},
                  rebound=twin_rebound))


def case_exposed_collective():
    dap = StandIn("dap", size=1)     # an async gather over the one rank
    x, w = _g(4, 8), _g(8, 8, seed=1)

    def exposed(x):
        return coll.all_gather_start(x, dap).wait() @ w

    def overlapped(x):
        pending = coll.all_gather_start(x, dap)
        y = x @ w                    # issued inside the gather's window
        return pending.wait() @ w + y

    return (_prog("exposed", {"step": _trace(exposed, x)},
                  expect_overlap=True),
            _prog("overlapped", {"step": _trace(overlapped, x)},
                  expect_overlap=True))


CASES = [
    # (id, mirrors tests/test_lint.py::..., pass, code, case function)
    ("unfused_opm", "test_unfused_opm_fixture_fires", MaterializationPass,
     "OPM_OUTER_MATERIALIZED", case_unfused_opm),
    ("trimult_pair", "test_trimult_gated_pair_fixture_fires",
     MaterializationPass, "TRIMULT_PAIR_MATERIALIZED",
     case_trimult_gated_pair),
    ("full_scores", "test_unchunked_attention_scores_fixture_fires",
     MaterializationPass, "FULL_ATTENTION_SCORES",
     case_unchunked_attention_scores),
    ("chunk_slab", "test_chunked_attention_slab_stays_clean",
     MaterializationPass, "FULL_ATTENTION_SCORES",
     case_chunked_attention_slab),
    ("grad_completion", "test_grad_completion_audit_fires_and_clears",
     CollectivesPass, "GRAD_COMPLETION_MISSING", case_grad_completion),
    ("dp_reduce", "test_dp_reduce_missing_fires", CollectivesPass,
     "DP_GRAD_REDUCE_MISSING", case_dp_reduce_missing),
    ("bf16_accum", "test_bf16_accumulation_fixture_fires", PrecisionPass,
     "BF16_ACCUM", case_bf16_accumulation),
    ("wgrad_dot", "test_weight_gradient_shaped_dot_stays_clean",
     PrecisionPass, "BF16_ACCUM", case_weight_gradient_dot),
    ("f32_accum", "test_f32_accumulation_stays_clean", PrecisionPass,
     "BF16_ACCUM", case_f32_accumulation),
    ("f64", "test_f64_fixture_fires", PrecisionPass, "F64_PRESENT",
     case_f64),
    ("low_prec_norm", "test_low_precision_norm_fixture_fires",
     PrecisionPass, "LOW_PRECISION_NORM", case_low_precision_norm),
    ("key_reuse", "test_reused_dropout_key_fixture_fires", RngPass,
     "KEY_REUSED", case_reused_dropout_key),
    ("key_split", "test_split_keys_stay_clean", RngPass, "KEY_REUSED",
     case_split_keys),
    ("loop_invariant", "test_loop_invariant_key_fixture_fires", RngPass,
     "RNG_LOOP_INVARIANT", case_loop_invariant_key),
    ("loop_folded", "test_folded_loop_key_stays_clean", RngPass,
     "RNG_LOOP_INVARIANT", case_folded_loop_key),
    ("weak_type", "test_weak_type_input_fixture_fires", RetracePass,
     "WEAK_TYPE_INPUT", case_weak_type_input),
    ("static_recycle", "test_static_recycle_retrace_fixture_fires",
     RetracePass, "STATIC_RECYCLE_RETRACE", case_static_recycle_retrace),
    ("donation", "test_donated_not_aliased_fixture_fires", RetracePass,
     "DONATED_NOT_ALIASED", case_donated_not_aliased),
    ("exposed", "test_exposed_collective_fixture_fires", RetracePass,
     "EXPOSED_COLLECTIVE", case_exposed_collective),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pass_fires_on_bug_and_stays_quiet_on_twin(case, world1):
    _, mirrors, pass_cls, code, build = case
    bug, twin = build()
    res = pass_cls().run(bug)
    assert not res.skipped, res.skip_reason
    assert code in {f.code for f in res.findings}, (mirrors, res.findings)
    quiet = pass_cls().run(twin)
    assert not quiet.skipped, quiet.skip_reason
    assert quiet.findings == [], (mirrors, quiet.findings)


# ---------------------------------------------------------------------------
# Parity with the reference's pure modules
# ---------------------------------------------------------------------------

FINDINGS = [
    ("precision", "BF16_ACCUM", "error", "train:serial",
     {"role": "fwd", "out_shape": [24, 2, 8]}),
    ("precision", "BF16_ACCUM", "error", "train:dap2",
     {"role": "fwd", "out_shape": [24, 2, 8]}),
    ("collectives", "GRAD_COMPLETION_MISSING", "error", "train:bp2",
     {"axis": "branch"}),
    ("materialization", "FULL_ATTENTION_SCORES", "error", "fold:serial",
     {"role": "step", "extent": 24}),
    ("retrace", "WEAK_TYPE_INPUT", "warning", "train:hybrid",
     {"arg_index": 3}),
    ("rng", "KEY_REUSED", "error", "train:dap2_sync", {}),
]


def test_fingerprints_and_report_summary_match_the_reference():
    from repro.analysis.static import core as jcore
    ours, theirs = [], []
    for pass_name, code, sev, prog, key in FINDINGS:
        ours.append(Finding(pass_name, code, sev, prog, "ours",
                            detail={"where": "a/b", "count": 3},
                            detail_key=key))
        theirs.append(jcore.Finding(pass_name, code, sev, prog, "theirs",
                                    detail={"where": "c/d"}, detail_key=key))
    assert [f.fingerprint for f in ours] == [f.fingerprint for f in theirs]
    assert len({f.fingerprint for f in ours}) == len(ours)
    waivers = {ours[0].fingerprint: "accepted: reason"}
    report = Report(results=[PassResult(f.pass_name, f.program, [f])
                             for f in ours] + [
        PassResult("rng", "fold:dap2", [], skipped=True, skip_reason="x")])
    jreport = jcore.Report(results=[jcore.PassResult(f.pass_name, f.program,
                                                     [f]) for f in theirs] + [
        jcore.PassResult("rng", "fold:dap2", [], skipped=True,
                         skip_reason="x")])
    assert (report.to_dict(waivers)["summary"]
            == jreport.to_dict(waivers)["summary"])
    assert report.to_dict(waivers)["waived"][0]["waiver_reason"] == \
        "accepted: reason"


def test_lint_config_thresholds_and_plan_matrices_match_the_reference():
    from repro.analysis.static import program as jprog
    from repro.analysis.static.passes import materialization as jmat
    from repro_torch.analysis.static import program as tprog
    from repro_torch.analysis.static.passes import materialization as tmat
    ours = [(lbl, thr, code) for lbl, thr, _, code in
            tmat.size_thresholds(tprog.lint_config())]
    theirs = [(lbl, thr, code) for lbl, thr, _, code in
              jmat.size_thresholds(jprog.lint_config())]
    assert ours == theirs and len(ours) == 4
    assert [(n, p.describe(), c) for n, p, c in tprog.train_plan_matrix()] \
        == [(n, p.describe(), c) for n, p, c in jprog.train_plan_matrix()]
    assert [(n, p.describe(), d) for n, p, d in tprog.fold_plan_matrix()] \
        == [(n, p.describe(), d) for n, p, d in jprog.fold_plan_matrix()]
    # the config is the reference's at every field but the kernel impls
    tcfg, jcfg = tprog.lint_config(), jprog.lint_config()
    for f in ("n_res", "n_seq", "n_extra_seq", "n_evoformer",
              "n_extra_msa_blocks"):
        assert getattr(tcfg, f) == getattr(jcfg, f)
    for stack in ("evoformer", "extra"):
        t, j = dataclasses.asdict(getattr(tcfg, stack)), \
            dataclasses.asdict(getattr(jcfg, stack))
        assert t.pop("attention_impl") == "evo_pallas"
        assert t.pop("tri_mult_impl") == "pallas"
        j.pop("attention_impl"), j.pop("tri_mult_impl")
        assert t == j
    assert dataclasses.asdict(tcfg.structure) == \
        dataclasses.asdict(jcfg.structure)


def test_baseline_loader_rejects_unknown_version(tmp_path):
    p = tmp_path / "b.json"
    p.write_text(json.dumps({"version": 2, "waivers": {}}))
    with pytest.raises(SystemExit):
        lint.load_baseline(p)
    p.write_text(json.dumps({"version": 1, "waivers": {"abc": "why"}}))
    assert lint.load_baseline(p)["waivers"] == {"abc": "why"}
    shipped = lint.load_baseline(lint.DEFAULT_BASELINE)
    assert shipped["version"] == 1
    assert all(r and not r.startswith("UNREVIEWED")
               for r in shipped["waivers"].values())


def test_op_trace_records_kernel_nodes_not_their_plain_ops():
    """A kernel entry point is one node (named after its kernel) with the
    kernel's outputs; switched off, its plain version's ops appear."""
    args = _tri_args()
    on = _trace(kops.triangle_mult, *args)
    off = _trace(kops.triangle_mult, *args, kernel_nodes=False)
    kernels = list(op_walk.iter_ops(on, ("kernel",)))
    assert [k.name for k in kernels] == ["triangle_mult_fwd"]
    assert kernels[0].out_shapes == (((R, R, CFG.c_z), "float32"),)
    assert len(on) == 1 and not list(op_walk.iter_ops(off, ("kernel",)))
    assert op_walk.peak_op_elems(off) == R * R * 2 * \
        CFG.evoformer.c_hidden_mul
    assert op_walk.count_ops(off, ["bmm"])["bmm"] >= 1


# ---------------------------------------------------------------------------
# The fold programs against the reference's (its capture runs on this JAX
# with jax.core's jaxpr classes pointed at jax.extend.core)
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_core_alias(monkeypatch):
    import jax.extend.core as xcore
    for name in ("ClosedJaxpr", "Jaxpr", "Literal", "Var"):
        monkeypatch.setattr(jax.core, name, getattr(xcore, name),
                            raising=False)


def _port_fold(name, dtype, **kw):
    """The port's fold program at the lint config, its weights carried
    across from the reference's layout by the bridge."""
    from repro_torch.analysis.static.program import capture_fold
    from repro_torch.core.model import AlphaFold2
    from repro_torch.parallel.plan import ParallelPlan
    from torch_util import af2_tree, load_into
    model = AlphaFold2(CFG, seed=0, device="cpu")
    load_into(model, af2_tree(CFG, seed=1))
    return capture_fold(name, ParallelPlan(), CFG, dtype=dtype, model=model,
                        **kw)


def _run_all(prog) -> list:
    from repro_torch.analysis.static import all_passes
    return [p.run(prog) for p in all_passes()]


@pytest.mark.parametrize("name,dtype", [("serial", "float32"),
                                        ("serial_bf16", "bfloat16")])
def test_fold_program_matches_the_reference(name, dtype, jax_core_alias):
    from repro.analysis.static import all_passes as jpasses
    from repro.analysis.static.program import capture_fold as jcapture
    from repro.analysis.static.program import fold_plan_matrix
    from repro.analysis.static.program import lint_config as jlint
    (plan,) = [p for n, p, _ in fold_plan_matrix() if n == name]
    jprog = jcapture(name, plan, jlint(), dtype=dtype)
    jres = [p.run(jprog) for p in jpasses()]
    ours = _run_all(_port_fold(name, dtype))
    assert [(r.pass_name, r.skipped) for r in ours] == \
        [(r.pass_name, r.skipped) for r in jres]
    codes = lambda res: sorted(f.code for r in res for f in r.findings)
    assert codes(ours) == codes(jres) == []
    peaks = ours[0].stats["peak_op_elems"]
    jpeaks = jres[0].stats["peak_eqn_elems"]
    assert peaks == jpeaks == {"fwd": 61440, "step": 61440}
    assert ours[0].stats["thresholds"] == jres[0].stats["thresholds"]


def test_kernel_boundary_is_what_keeps_the_fold_clean():
    """With the kernel nodes switched off, the plain K1's logits
    (``kernels/ref.py``: einsum to (l, h, s, t)) and the plain K3's packed
    (r, r, 2·c_mul) projection are op outputs, and both guarantees fire."""
    prog = _port_fold("serial", "float32", kernel_nodes=False)
    res = _run_all(prog)[0]
    codes = {f.code for f in res.findings}
    assert {"FULL_ATTENTION_SCORES", "TRIMULT_PAIR_MATERIALIZED"} <= codes
    assert res.stats["peak_op_elems"]["step"] == \
        R * R * 2 * CFG.evoformer.c_hidden_mul


# ---------------------------------------------------------------------------
# The trainer's hlo_check
# ---------------------------------------------------------------------------

def test_trainer_hlo_check_records_the_overlap_verdict():
    """``record_async_overlap`` traces the step body and restores the
    state; through ``run`` it is recorded once before the first step, which
    then trains exactly as a runner without the check does."""
    from repro_torch.core.config import af2_tiny
    from repro_torch.data.protein import protein_batch
    from repro_torch.train.trainer import TrainRunner

    def runner(check):
        return TrainRunner(af2_tiny(n_evoformer=1), device="cpu", seed=3,
                           ema_decay=None, recycle_sample=False,
                           hlo_check=check, data_workers=0)

    a, b = runner(True), runner(False)
    before = {k: t.clone() for k, t in state_tensors(a.state).items()}
    row = a.record_async_overlap(protein_batch(3, 0, 1, a.cfg))
    assert {"ok", "skipped", "reason", "pairs"} <= set(row)
    assert row["ok"] is None and row["skipped"] and row["pairs"] == 0
    assert row["reason"]
    after = state_tensors(a.state)
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert (a.step, a.state["opt"].step, a.train_compiles) == (0, 0, 0)
    a.run(1)
    b.run(1)
    assert len(a.obs.series("train/async_overlap_ok")) == 2
    assert a.train_compiles == b.train_compiles == 1
    assert a.history["loss"] == b.history["loss"]
    got, want = state_tensors(a.state), state_tensors(b.state)
    assert all(torch.equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------

def test_torchrun_launch_lints_its_plan_then_trains(gate_runs):
    """``torch.distributed.run`` over two CPU ranks, BP 2, ``--lint``: the
    lint line prints once (rank 0) with 0 unwaived, and the step completes
    on both ranks (torchrun exits 0 only if every rank did)."""
    rc, out, err = _finish(gate_runs["torchrun"][0])
    assert rc == 0, (out[-3000:], err[-3000:])
    lint_lines = [ln for ln in out.splitlines() if ln.startswith("lint:")]
    assert len(lint_lines) == 1, out[-3000:]
    assert "bp=2" in lint_lines[0] and "(0 unwaived)" in lint_lines[0]
    assert "across 5 passes" in lint_lines[0]
    assert "done: 1 steps" in out


SYNC_AXES = {"bp2": ("branch",), "dap2": ("dap",), "dap2_sync": ("dap",),
             "hybrid": ("branch", "dap")}


def test_cli_full_matrix_gates_clean(gate_runs):
    """The port's gate: the committed baseline admits zero unwaived
    findings across every train and fold plan of the matrix; every sync
    axis's psums in the step exceed the no-completion baseline's on every
    rank, and the serial plan reduces over its data axis."""
    proc, report = gate_runs["cli"]
    rc, out, err = _finish(proc)
    assert rc == 0, (out[-3000:], err[-3000:])
    assert "lint: OK" in out
    data = json.loads(report.read_text())
    s = data["summary"]
    assert (s["n_programs"], s["n_pass_runs"], s["n_skipped"],
            s["n_unwaived"]) == (8, 40, 0, 0)
    stats = {(r["program"], r["pass"]): r["stats"] for r in data["results"]}
    for name, axes in SYNC_AXES.items():
        st = stats[(f"train:{name}", "collectives")]
        for one in [st, *st.get("by_rank", {}).values()]:
            for ax in axes:
                assert one["step"].get(f"psum@{ax}", 0) > \
                    one["grad_nocomplete"].get(f"psum@{ax}", 0), (name, one)
    assert stats[("train:serial", "collectives")]["step"]["psum@data"] >= 1
    assert stats[("fold:serial", "materialization")]["peak_op_elems"] == \
        {"fwd": 61440, "step": 61440}
    for prog in ("train:dap2", "fold:dap2"):
        assert "pairs overlapped" in stats[(prog, "retrace")]["overlap"]
