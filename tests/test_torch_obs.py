"""The port's telemetry (``repro_torch.obs``) and the rest of its roofline
against the JAX package's ``repro.obs`` and ``repro.analysis.roofline``,
run side by side on the CPU, and the telemetry wired through the port's
training, checkpoints, data pipeline and launchers at af2_tiny.

Registry row streams must be equal after ``strip_walltimes`` (the one
wall-clock field), console lines equal, histogram payloads equal;
``af2_model_flops``, ``model_flops`` and ``active_params`` exactly equal;
``predict_step_time`` and ``attribution_report`` equal to 1e-12 relative
when the port's ``HW`` carries the reference's constants.
"""
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import obs as jobs
from repro.analysis import roofline as jroof
from repro.core import config as jcore
from repro.obs.sinks import strip_walltimes as jstrip
from repro.parallel.plan import ParallelPlan as JaxParallelPlan

from repro_torch import configs as tconfigs
from repro_torch import obs as tobs
from repro_torch.analysis import roofline as troof
from repro_torch.core import config as tcore
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.obs.sinks import strip_walltimes
from repro_torch.parallel.plan import ParallelPlan
from repro_torch.train import checkpoint as ck
from repro_torch.train.trainer import TrainRunner

import torch_threads  # noqa: F401  (one intra-op thread)

RTOL = 1e-12
# the reference's TPU v5e constants, given to the port's HW
REF_HW = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9,
              coll_launch=20e-6, tile_rows=256.0, overlap_eff=0.5)


# ---------------------------------------------------------------------------
# Registry and sinks
# ---------------------------------------------------------------------------

def _drive(reg, seed):
    """A recording sequence drawn from ``seed``: tagged counters, gauges
    and histograms, events with numpy and dict values, ticks; the last tick
    changes nothing."""
    rng = np.random.default_rng(seed)
    for step in range(6):
        reg.counter("serve/requests").inc(int(rng.integers(1, 4)))
        reg.counter("serve/bucket_steps", bucket=f"r<={8 << (step % 2)}").inc()
        reg.gauge("data/stall_fraction").set(float(rng.random()))
        h = reg.histogram("train/step_s", window=4)
        for v in rng.random(3):
            h.observe(np.float32(v))
        reg.record("train/loss", np.float64(rng.standard_normal()), step=step)
        reg.record("train/data", {"step": step, "fill": np.float32(0.5),
                                  "buckets": (1, 2)}, step=step, run="a")
        if step % 3 == 2:
            reg.record("serve/call", {"call": "run", "steps": step})
        reg.tick(step=step)
    reg.tick(step=99)


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_rows_equal_the_reference(tmp_path, seed):
    streams = []
    for lib, strip in ((jobs, jstrip), (tobs, strip_walltimes)):
        path = tmp_path / f"{lib.__name__}.jsonl"
        mem = lib.MemorySink()
        reg = lib.MetricRegistry(sinks=[lib.JsonlSink(path), mem])
        _drive(reg, seed)
        reg.close()
        streams.append((strip(path.read_text().splitlines()), mem, reg))
    (want, jmem, jreg), (got, tmem, treg) = streams
    assert got == want and len(got) > 40
    assert [dict(r, t=0) for r in tmem.rows] == [dict(r, t=0) for r in jmem.rows]
    assert treg.snapshot() == jreg.snapshot()
    # seq is the row order; the unchanged last tick writes only its tick row
    assert [r["seq"] for r in tmem.rows] == list(range(len(tmem.rows)))
    assert [r["kind"] for r in tmem.rows if r["step"] == 99] == ["tick"]
    assert tmem.events("train/loss") and len(tmem.events()) == 14


def test_series_is_live_and_kinds_do_not_collide():
    reg = tobs.MetricRegistry()
    view = reg.series("train/loss")
    reg.record("train/loss", 1.5, step=0)
    reg.record("train/loss", 1.25, step=1)
    assert view == [1.5, 1.25] and reg.series("train/loss") is view
    reg.counter("x")
    jreg = jobs.MetricRegistry()
    jreg.counter("x")
    with pytest.raises(ValueError) as got:
        reg.gauge("x")
    with pytest.raises(ValueError) as want:
        jreg.gauge("x")
    assert str(got.value) == str(want.value)


def test_histogram_quantiles_across_a_window_wrap():
    rng = np.random.default_rng(7)
    xs = rng.standard_normal(50)
    hs = [lib.MetricRegistry().histogram("lat", window=16)
          for lib in (jobs, tobs)]
    for h in hs:
        for v in xs:
            h.observe(v)
    assert hs[1].payload() == hs[0].payload()
    last = xs[-16:]
    for q in (0.0, 0.37, 0.5, 0.99, 1.0):
        assert hs[1].quantile(q) == pytest.approx(
            np.quantile(last, q), rel=RTOL, abs=1e-15)
    p = hs[1].payload()
    assert p["count"] == 50 and p["min"] == xs.min() and p["max"] == xs.max()


def test_console_sink_lines_equal_the_reference():
    lines = {}
    for lib in (jobs, tobs):
        out = lines[lib.__name__] = []
        sink = lib.ConsoleSink(every=2, log=out.append,
                               prefixes=("data/", "train/"))
        reg = lib.MetricRegistry(sinks=[sink])
        _drive(reg, 3)
        reg.close()
    assert lines["repro_torch.obs"] == lines["repro.obs"]
    assert len(lines["repro.obs"]) == 4     # steps 0, 2, 4 and the close
    assert "serve/" not in "".join(lines["repro.obs"])
    with pytest.raises(ValueError, match="every must be >= 1"):
        tobs.ConsoleSink(every=0)


# ---------------------------------------------------------------------------
# Spans and the profiler window
# ---------------------------------------------------------------------------

def _spans(lib):
    tr = lib.SpanTracer(process_name="p")
    with tr.span("step", step=1, n_recycle=2):
        with tr.span("featurize", bucket=(8, 4)):
            pass
        with tr.span("eval"):
            with tr.span("inner"):
                pass

    def work():
        with tr.span("featurize", step=2):
            pass
    worker = threading.Thread(target=work, name="featurize-0")
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive()
    return tr


def test_span_tracer_nesting_threads_and_chrome_schema(tmp_path):
    tr, jtr = _spans(tobs), _spans(jobs)
    strip = lambda t: [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                       for e in t.to_chrome_trace()["traceEvents"]]
    assert strip(tr) == strip(jtr)
    assert [e["name"] for e in tr.spans()] == [
        "featurize", "inner", "eval", "step", "featurize"]
    by = {(e["name"], e["args"]["depth"]): e for e in tr.spans()}
    outer = by["step", 0]
    for child in (by["featurize", 1], by["eval", 1]):
        assert outer["ts"] <= child["ts"]
        assert child["ts"] + child["dur"] <= outer["ts"] + outer["dur"]
    assert by["featurize", 0]["tid"] != outer["tid"]
    assert by["featurize", 1]["args"]["bucket"] == "(8, 4)"
    path = tmp_path / "trace.json"
    tr.save(path)
    doc = json.loads(path.read_text())
    meta = {e["args"]["name"] for e in doc["traceEvents"]
            if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "featurize-0" in meta and doc["displayTimeUnit"] == "ms"
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(e)
            assert e["dur"] >= 0.0 and isinstance(e["tid"], int)


def test_trace_span_noop_and_global_tracer():
    assert tobs.get_tracer() is None
    with tobs.trace_span("nobody-listening") as t:
        assert t is None
    tr = tobs.SpanTracer()
    prev = tobs.set_tracer(tr)
    try:
        assert tobs.get_tracer() is tr
        with tobs.trace_span("global", step=4):
            pass
    finally:
        tobs.set_tracer(prev)
    assert [e["args"] for e in tr.spans("global")] == [{"step": 4, "depth": 0}]
    assert tobs.parse_profile_steps("3:7") == jobs.parse_profile_steps("3:7")
    for bad in ("7:3", "3:3"):
        with pytest.raises(ValueError, match="A < B"):
            tobs.parse_profile_steps(bad)


def test_profile_window_captures_only_its_steps(tmp_path):
    logs = []
    win = tobs.ProfileWindow(1, 3, str(tmp_path / "prof"), log=logs.append,
                             device="cpu")
    x = torch.ones(8)
    for step in range(5):
        win.maybe_start(step)
        with torch.profiler.record_function(f"work_{step}"):
            x = x * 1.5
        win.maybe_stop(step)
    win.close()
    assert not win.active and win.trace_path.endswith(
        "steps_1-3.pt.trace.json")
    names = {e.get("name") for e in
             json.loads(open(win.trace_path).read())["traceEvents"]}
    assert {"work_1", "work_2"} <= names
    assert not names & {"work_0", "work_3", "work_4"}
    # a failure to write the trace is logged and does not end the run
    bad = tobs.ProfileWindow(0, 1, str(tmp_path / "prof" / win.trace_path),
                             log=logs.append)
    bad.maybe_start(0)
    bad.maybe_stop(0)
    assert not bad.active and bad.trace_path is None
    assert "stop failed" in logs[-1]


# ---------------------------------------------------------------------------
# Roofline and attribution
# ---------------------------------------------------------------------------

def test_hw_keeps_the_h100_values():
    assert dataclasses.asdict(troof.HW()) == dict(
        peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9, coll_launch=10e-6,
        tile_rows=128.0, overlap_eff=0.5)


@pytest.mark.parametrize("name", ["tiny", "small", "initial", "finetune"])
def test_af2_model_flops_equal_the_reference(name):
    want = getattr(jcore, f"af2_{name}")()
    got = tcore.PRESETS[name]()
    for nr in (1.0, 2.0, 2.5):
        assert troof.af2_model_flops(got, nr) == jroof.af2_model_flops(want,
                                                                       nr)


def test_lm_model_flops_and_active_params_equal_the_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS and len(tconfigs.ARCH_IDS) == 10
    for arch in tconfigs.ARCH_IDS:
        got, want = tconfigs.get_config(arch), jconfigs.get_config(arch)
        assert troof.active_params(got) == jroof.active_params(want), arch
        for kind, s, b in (("train", 4096, 8), ("prefill", 2048, 1),
                           ("decode", 1, 4)):
            assert troof.model_flops(got, kind, s, b) == \
                jroof.model_flops(want, kind, s, b), (arch, kind)


def test_roofline_terms_equal_the_reference():
    kw = dict(total_flops=3.1e15, total_bytes=7.7e12,
              total_collective_bytes=2.9e12, chips=4)
    got = troof.roofline_terms(**kw, hw=troof.HW(**REF_HW))
    want = jroof.roofline_terms(**kw)
    assert got == want and got["dominant"] == "collective"


PLANS = [(1, 1), (2, 1), (1, 2), (2, 2)]


@pytest.mark.parametrize("bp,dap", PLANS)
def test_predict_step_time_and_attribution_equal_the_reference(bp, dap):
    hw = troof.HW(**REF_HW)
    got_cfg, want_cfg = tcore.af2_initial(), jcore.af2_initial()
    for nr in (1, 2.5):
        kw = dict(bp=bp, dap=dap, pod=2, data=3, global_batch=12,
                  n_recycle=nr)
        got = troof.predict_step_time(got_cfg, hw=hw, **kw)
        want = jroof.predict_step_time(want_cfg, **kw)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=RTOL), (k, nr)
        plan_kw = dict(pod=2, data=3, branch=bp, dap=dap)
        rep_kw = dict(global_batch=12, n_recycle=nr, measured_step_s=1.7,
                      stall_fraction=0.05, overhead_s=2.0, wall_s=40.0,
                      step=9)
        got = tobs.attribution_report(got_cfg, ParallelPlan(**plan_kw),
                                      hw=hw, **rep_kw)
        want = jobs.attribution_report(want_cfg, JaxParallelPlan(**plan_kw),
                                       **rep_kw)
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, float):
                assert got[k] == pytest.approx(v, rel=RTOL), (k, nr)
            else:
                assert got[k] == v, k
        assert tobs.describe_attribution(got) == \
            jobs.describe_attribution(want)


def test_attribution_on_the_h100_of_af2_initial():
    """The cost model's reading of the port's training step (kernel impls,
    ``n_recycle`` 2): 4.306e13 model FLOPs and ~43.5 ms predicted."""
    cfg = tcore.with_kernels(tcore.af2_initial())
    rep = tobs.attribution_report(cfg, ParallelPlan(), global_batch=1,
                                  n_recycle=2, measured_step_s=1.8085)
    assert rep["model_flops_per_step"] == pytest.approx(4.306e13, rel=1e-3)
    assert rep["predicted_step_s"] == pytest.approx(0.04354, rel=1e-3)
    assert rep["mfu"] == pytest.approx(4.306e13 / 1.8085 / 989e12, rel=1e-3)


# ---------------------------------------------------------------------------
# Wiring at af2_tiny
# ---------------------------------------------------------------------------

def _cfg():
    return tcore.af2_tiny(n_evoformer=1, n_extra_msa_blocks=1, n_res=8,
                          n_seq=4, n_extra_seq=6)


def test_trainrunner_history_is_registry_view_and_spans_cover_stages(
        tmp_path):
    sink = tobs.MemorySink()
    reg = tobs.MetricRegistry(sinks=[sink])
    tr = tobs.SpanTracer()
    runner = TrainRunner(
        _cfg(), batch_size=2, seed=0, max_recycle=2, eval_every=2,
        ckpt_dir=str(tmp_path / "ck"), ckpt_every=2, obs=reg, tracer=tr,
        device="cpu")
    hist = runner.run(4)
    for key in ("loss", "n_recycle", "step_s", "eval", "data",
                "attribution"):
        assert hist[key] is reg.series(f"train/{key}")
    assert len(hist["loss"]) == 4
    assert [r["value"] for r in sink.events("train/loss")] == hist["loss"]
    # step_s holds the watchdog's EMA, as the reference records it
    assert hist["step_s"][-1] == runner.watchdog.ema
    assert len(hist["attribution"]) == 2
    for a in hist["attribution"]:
        assert {"measured_step_s", "predicted_step_s", "mfu", "goodput",
                "stall_fraction"} <= set(a)
        assert 0.0 < a["mfu"] <= 1.0
    names = {e["name"] for e in tr.spans()}
    assert {"featurize", "device_put", "input_wait", "step", "eval",
            "checkpoint"} <= names
    steps = tr.spans("step")
    assert [(e["args"]["step"], e["args"]["n_recycle"]) for e in steps] == \
        list(enumerate(hist["n_recycle"]))
    main = steps[0]["tid"]
    assert all(e["tid"] != main for e in tr.spans("featurize"))
    assert len(tr.spans("eval")) == 2 and len(tr.spans("checkpoint")) == 2
    for k in ("snapshot_s", "save_s"):
        assert runner.mgr.stats[k] is reg.series(f"ckpt/{k}")
        assert len(runner.mgr.stats[k]) == 2
    snap = reg.snapshot()
    assert snap["train/steps"] == {"value": 4}
    assert snap["train/step_s"]["count"] == 4
    assert {"data/stall_fraction", "data/featurize_s", "data/mean_fill"} <= \
        set(snap)


def test_checkpoint_stats_are_registry_series(tmp_path):
    reg = tobs.MetricRegistry()
    mgr = ck.CheckpointManager(tmp_path, keep=1, obs=reg)
    tree = {"w": torch.ones(3)}
    mgr.save(2, tree)
    mgr.wait()
    _, step = mgr.restore({"w": torch.zeros(3)})
    assert step == 2
    for k in ("snapshot_s", "save_s", "restore_s"):
        assert mgr.stats[k] is reg.series(f"ckpt/{k}") and len(mgr.stats[k]) == 1
    own = ck.CheckpointManager(tmp_path)    # a registry of its own
    assert own.stats["save_s"] is own.obs.series("ckpt/save_s")


def _jsonl(path):
    rows = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [r["seq"] for r in rows] == list(range(len(rows)))
    return rows


def test_train_launcher_writes_metrics_and_trace(tmp_path, capsys):
    m, t = tmp_path / "m.jsonl", tmp_path / "t.json"
    runner = launch_train.main([
        "--af2", "tiny", "--steps", "2", "--batch", "1", "--device", "cpu",
        "--metrics-out", str(m), "--trace-out", str(t)])
    out = capsys.readouterr().out
    assert "attribution[step 2]" in out and "trace: " in out
    rows = _jsonl(m)
    assert [r["value"] for r in rows if r["name"] == "train/loss"] == \
        runner.history["loss"]
    assert sum(r["name"] == "train/attribution" for r in rows) == 1
    doc = json.loads(t.read_text())
    assert [e["args"]["step"] for e in doc["traceEvents"]
            if e["name"] == "step"] == [0, 1]


def test_serve_launcher_writes_metrics_and_trace(tmp_path):
    m, t = tmp_path / "s.jsonl", tmp_path / "s.json"
    done = launch_serve.main([
        "--fold", "tiny", "--device", "cpu", "--requests", "3",
        "--metrics-out", str(m), "--trace-out", str(t)])
    assert len(done) == 3
    rows = _jsonl(m)
    calls = [r["value"] for r in rows if r["name"] == "serve/call"]
    assert [c["call"] for c in calls] == ["run"] and calls[0]["requests"] == 3
    counters = {r["name"]: r["value"] for r in rows if r["kind"] == "counter"
                and not r["tags"]}
    assert counters["serve/requests"] == 3
    doc = json.loads(t.read_text())
    folds = [e for e in doc["traceEvents"] if e["name"] == "fold_step"]
    assert len(folds) == counters["serve/steps"] == calls[0]["steps"]
