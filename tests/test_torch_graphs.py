"""The port's captured steps (``repro_torch.graphs``): the sample-cycle
``FoldEngine`` captures, the ``DecodeEngine`` steps' static buffers, the
launch credits of a replay, and (on the card) graphed against eager
serving, bit for bit, graphed against eager training (``TrainRunner``,
one graph per drawn ``n_recycle``) with its evaluation, a checkpoint
restored into a captured training graph, and the data pipeline's batches
placed on the card.

CPU cases run at af2_tiny and glm4-9b's reduced config; the ``cuda`` cases
skip without a card (the ``cuda_dev`` fixture decides at run time).  On the
card: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_graphs.py``.

Tolerance: none for serving.  A graph replays the launches of the eager
step it was captured from, in the same order on the same inputs, and no
kernel sums with atomics, so graphed and eager results are compared for
equality.  Training is held to the distance between two eager runs of the
same steps, since autograd's own backward kernels (index and scatter
gradients) may sum with atomics.
"""
import contextlib
import copy
import gc

import numpy as np
import pytest
import torch

from repro_torch import configs, graphs
from repro_torch.core import evoformer as evo
from repro_torch.core import model as af2
from repro_torch.core.config import af2_tiny, with_kernels
from repro_torch.data import bucketing as bk
from repro_torch.data.ingest import FastaSource, demo_fasta
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import make_fold_requests
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import ops
from repro_torch.models import dense, get_model
from repro_torch.models.lmconfig import with_kernels as lm_with_kernels
from repro_torch.serve import fold_steps as fs
from repro_torch.serve.engine import DecodeEngine, Request
from repro_torch.serve.fold_engine import FoldEngine
from repro_torch.train.trainer import TrainRunner

import torch_threads  # noqa: F401  (one intra-op thread)

CFG = with_kernels(af2_tiny())
LM_CFG = lm_with_kernels(configs.get_smoke_config("glm4-9b"))


def _fold_model(seed=0, noise=0.1):
    """af2_tiny at its seeded init, every parameter perturbed (AF2's zero-
    init output layers would otherwise hide most of the trunk)."""
    model = af2.AlphaFold2(CFG, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(noise * torch.randn(p.shape, generator=g))
    return model


def _padded_batch(n=2):
    reqs = make_fold_requests(CFG, n, seed=5, fracs=(1.0, 0.6))
    bucket = fs.Bucket(CFG.n_res, CFG.n_seq, CFG.n_extra_seq)
    return fs.stack_padded([fs.pad_to_bucket(r.features, bucket)
                            for r in reqs], n)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, LM_CFG.vocab, n, dtype=np.int32) for n in lengths]


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def test_sample_cycle_reproduces_fold_cycles_carry():
    """fold_cycle with sample 1 frozen equals sample_cycle driven on sample
    0 alone, from a nonzero carry, exactly."""
    model = _fold_model()
    batch = af2.to_device(_padded_batch(), "cpu")
    bsz, r = batch["target_feat"].shape[:2]
    g = torch.Generator().manual_seed(2)
    prev = (torch.randn((bsz, r, CFG.c_m), generator=g),
            torch.randn((bsz, r, r, CFG.c_z), generator=g),
            3.0 * torch.randn((bsz, r, 3), generator=g))
    sf = torch.randn((bsz, r, CFG.structure.c_s), generator=g)
    pair_mask, pair_count = af2.fold_pair_mask(batch)
    with torch.no_grad():
        new_prev, new_sf, _, n_rec = af2.fold_cycle(
            model, CFG, batch, prev, sf, torch.tensor([False, True]),
            torch.zeros(bsz, dtype=torch.int32), tol=0.0,
            pair_mask=pair_mask, pair_count=pair_count, dtype=torch.float32)
        want = af2.sample_cycle(model, CFG, {k: v[0] for k, v in batch.items()},
                                tuple(t[0] for t in prev), dtype=torch.float32)
    for got, w, old in zip((*new_prev, new_sf), want, (*prev, sf)):
        assert torch.equal(got[0], w)
        assert torch.equal(got[1], old[1])      # the frozen sample's carry
    assert n_rec.tolist() == [1, 0]


def test_graphs_need_a_cuda_device():
    cpu = torch.device("cpu")
    assert graphs.use_graphs(None, cpu) is False
    assert graphs.use_graphs(False, cpu) is False
    with pytest.raises(ValueError, match="CUDA"):
        graphs.use_graphs(True, cpu)
    with pytest.raises(ValueError, match="CUDA"):
        graphs.CapturedStep(lambda x: x)(torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA"):
        FoldEngine(CFG, _fold_model(), device="cpu", graphs=True)
    params = dense.init_params(LM_CFG, seed=0, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        DecodeEngine(get_model(LM_CFG), LM_CFG, params, batch_slots=1,
                     max_len=16, device="cpu", graphs=True)
    engine = DecodeEngine(get_model(LM_CFG), LM_CFG, params, batch_slots=1,
                          max_len=16, device="cpu")
    assert engine.graphs is False and engine.compile_misses == 1
    with pytest.raises(ValueError, match="CUDA"):
        TrainRunner(CFG, device="cpu", graphs=True)
    assert TrainRunner(CFG, device="cpu").graphs is False


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fold_engine_loads_weights_into_its_storage(dtype):
    """load_weights copies into the cast module the graphs read: same
    tensors, same storage, the new values in the engine's dtype; a model
    or a dict by key path (an EMA).  The engine owns that storage, also
    when the model is already in its dtype: the caller's model is never
    written."""
    model = _fold_model(seed=0)
    before = {k: p.clone() for k, p in model.named_parameters()}
    engine = FoldEngine(CFG, model, device="cpu", dtype=dtype)
    params = list(engine.params.parameters())
    ptrs = [p.data_ptr() for p in params]
    new = _fold_model(seed=4)
    for weights in (new, {k: p.detach() for k, p in new.named_parameters()}):
        engine.load_weights(weights)
        assert list(engine.params.parameters()) == params
        assert [p.data_ptr() for p in params] == ptrs
        for got, src in zip(params, new.parameters()):
            assert got.dtype == dtype
            assert torch.equal(got, src.to(dtype))
    assert all(torch.equal(p, before[k]) for k, p in model.named_parameters())
    with pytest.raises(ValueError, match="match"):
        engine.load_weights({"heads.distogram.w": params[0]})


def test_decode_engine_reused_slot_equals_fresh_engines():
    """One slot serves a longer then a shorter prompt: the tokens, and the
    slot's whole cache, are those of a fresh engine per prompt, so the
    static batch-1 prefill cache is zeroed before each prefill.  The
    engine built its decode step and one prefill step per length."""
    params = dense.init_params(LM_CFG, seed=2, device="cpu")
    long, short = _prompts((12, 5), seed=2)
    kw = dict(batch_slots=1, max_len=24, device="cpu")

    def engine():
        return DecodeEngine(get_model(LM_CFG), LM_CFG, params, **kw)

    both = engine()
    done = both.run([Request(rid=0, prompt=long, max_new_tokens=4),
                     Request(rid=1, prompt=short, max_new_tokens=4)])
    assert both.compile_misses == 1 + 2
    fresh = [engine(), engine()]
    want = [e.run([Request(rid=i, prompt=p, max_new_tokens=4)])[i]
            for i, (e, p) in enumerate(zip(fresh, (long, short)))]
    assert [done[0], done[1]] == want
    for key in ("k", "v", "length"):
        assert torch.equal(both.cache[key], fresh[1].cache[key]), key
    assert not both.cache["k"][:, 0, len(short) + 3:].any()


class _FakeStream:
    device = torch.device("cpu")

    def wait_stream(self, other):
        pass


class _FakeGraph:
    def replay(self):
        pass


def test_captured_step_credits_a_captures_launches_once_per_replay(
        monkeypatch):
    """With the CUDA calls stubbed: the first call runs the function (its
    launches count), the capture's own counts are taken back, and each
    replay copies its argument into the static input and credits the
    capture's launches once."""
    for name, fake in (("Stream", lambda device=None: _FakeStream()),
                       ("current_stream", lambda: _FakeStream()),
                       ("stream", lambda s: contextlib.nullcontext()),
                       ("CUDAGraph", _FakeGraph),
                       ("graph", lambda g, pool=None:
                        contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, fake)
    monkeypatch.setattr(graphs, "_require_cuda", lambda args: None)

    def two_launches(x):
        kf.launches += 2        # as if K6 ran twice
        return x * 2

    ops.reset_launch_counts()
    step = graphs.CapturedStep(two_launches)
    x = torch.arange(4.0)
    assert torch.equal(step(x), 2 * x)
    assert step.launches == {"flash_attention_fwd": 2}
    assert ops.launch_counts()["flash_attention_fwd"] == 2
    for i in range(3):
        y = torch.full((4,), float(i))
        step(y)
        assert torch.equal(step.inputs[0], y)
    counts = ops.launch_counts()
    assert counts["flash_attention_fwd"] == 2 + 3 * 2
    assert sum(counts.values()) == 8
    with pytest.raises(ValueError, match="captured with"):
        step(torch.zeros(5))
    ops.add_launch_counts({"evo_attention_fwd": 5, "flash_attention_fwd": -8})
    assert ops.launch_counts() == {**counts, "evo_attention_fwd": 5,
                                   "flash_attention_fwd": 0}
    ops.reset_launch_counts()


def test_capture_collects_first_and_holds_the_collector_off(monkeypatch):
    """With the CUDA calls stubbed: a dead object in a reference cycle is
    collected before the capture begins, the collector is off while the
    function is captured (so no dead graph is freed inside the capture),
    and it is on again after the capture, also after one that raised."""
    seen = {}

    @contextlib.contextmanager
    def fake_graph(g, pool=None):
        seen["collected_before"] = seen.get("finalized", False)
        yield

    for name, fake in (("Stream", lambda device=None: _FakeStream()),
                       ("current_stream", lambda: _FakeStream()),
                       ("stream", lambda s: contextlib.nullcontext()),
                       ("CUDAGraph", _FakeGraph), ("graph", fake_graph)):
        monkeypatch.setattr(torch.cuda, name, fake)
    monkeypatch.setattr(graphs, "_require_cuda", lambda args: None)

    class Dead:
        def __del__(self):
            seen["finalized"] = True

    calls = []

    def fn(x):
        calls.append(gc.isenabled())
        if len(calls) == 4:
            raise RuntimeError("capture failed")
        return x + 1

    assert gc.isenabled()
    dead = Dead()
    dead.self = dead
    del dead
    step = graphs.CapturedStep(fn)
    step(torch.zeros(2))
    assert seen["collected_before"]
    assert calls == [True, False]            # warm-up on, capture off
    assert gc.isenabled()
    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.CapturedStep(fn)(torch.zeros(2))
    assert calls[2:] == [True, False] and gc.isenabled()


# ---------------------------------------------------------------------------
# CUDA
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def captures(monkeypatch):
    """Counts the graphs captured (``CapturedStep._capture`` calls)."""
    n = []
    capture = graphs.CapturedStep._capture

    def counted(self, args):
        n.append(1)
        return capture(self, args)

    monkeypatch.setattr(graphs.CapturedStep, "_capture", counted)
    return n


def _serve_folds(engine, reqs):
    ops.reset_launch_counts()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    return done, ops.launch_counts()


@pytest.mark.cuda
def test_graphed_fold_equals_eager_bit_for_bit(cuda_dev, captures):
    """af2_tiny, 5 requests over 2 buckets, micro-batch 2, 3 recycles: the
    graphed engine's coordinates, pLDDT and recycle counts equal the eager
    engine's exactly; one capture per bucket, none on a second run; the
    launches credited by replays equal the eager run's."""
    model = _fold_model()
    reqs = make_fold_requests(CFG, 5, seed=1, fracs=(1.0, 0.3))
    buckets = [fs.Bucket(8, 4, 6), fs.Bucket(CFG.n_res, CFG.n_seq,
                                              CFG.n_extra_seq)]
    kw = dict(buckets=buckets, micro_batch=2, max_recycle=3, device=cuda_dev)
    eager = FoldEngine(CFG, model, graphs=False, **kw)
    want, want_counts = _serve_folds(eager, reqs)
    graphed = FoldEngine(CFG, model, **kw)
    assert graphed.graphs
    for run in range(2):
        got, counts = _serve_folds(graphed, reqs)
        assert graphed.compile_misses == len(captures) == 2
        assert counts == want_counts
        assert counts["evo_attention_fwd"] > 0
        assert counts["triangle_mult_fwd"] > 0
        for rid, w in want.items():
            assert torch.equal(torch.as_tensor(got[rid].coords),
                               torch.as_tensor(w.coords)), (run, rid)
            assert np.array_equal(got[rid].plddt, w.plddt)
            assert got[rid].n_recycles == w.n_recycles == 3


def _recorded(engine):
    """Wrap the engine's steps to keep every logits row they return."""
    rows = []
    prefill, decode = engine._prefill1, engine._decode

    def rec_prefill(prompt):
        out = prefill(prompt)
        rows.append(out.clone())
        return out

    def rec_decode(tokens):
        out = decode(tokens)
        rows.append(out.clone())
        return out

    engine._prefill1, engine._decode = rec_prefill, rec_decode
    return rows


@pytest.mark.cuda
def test_graphed_decode_and_prefill_equal_eager_bit_for_bit(cuda_dev,
                                                            captures):
    """glm4-9b's reduced config, 2 slots, 5 requests of 3 prompt lengths:
    every logits row of the graphed engine's prefills and decode steps, and
    so every token, equals the eager engine's; one capture for decode and
    one per prompt length; the credited K6 launches equal the eager run's
    (one per layer per prompt)."""
    params = dense.init_params(LM_CFG, seed=0, device=cuda_dev,
                               dtype=torch.bfloat16)
    lengths = (40, 17, 40, 100, 17)
    prompts = _prompts(lengths, seed=1)
    out = []
    for use in (False, True):
        engine = DecodeEngine(get_model(LM_CFG), LM_CFG, params,
                              batch_slots=2, max_len=128, device=cuda_dev,
                              graphs=use)
        rows = _recorded(engine)
        ops.reset_launch_counts()
        done = engine.run([Request(rid=i, prompt=p, max_new_tokens=6)
                           for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert engine.compile_misses == 1 + 3
        assert counts["flash_attention_fwd"] == LM_CFG.n_layer * len(prompts)
        out.append((done, rows, counts))
    assert len(captures) == 1 + 3
    (want, want_rows, want_counts), (got, rows, counts) = out
    assert got == want and counts == want_counts
    assert len(rows) == len(want_rows)
    for i, (g, w) in enumerate(zip(rows, want_rows)):
        assert torch.equal(g, w), i


def _train_diff(a, b) -> dict:
    """Max |diff| of two runners' losses, parameters and EMA."""
    return {
        "loss": max(abs(x - y) for x, y in zip(a.history["loss"],
                                                 b.history["loss"])),
        "params": max((p - q).abs().max().item() for p, q in
                      zip(a.model.parameters(), b.model.parameters())),
        "ema": max((a.state["ema"][k] - b.state["ema"][k]).abs().max().item()
                   for k in a.state["ema"])}


@pytest.mark.cuda
def test_graphed_training_equals_eager_and_evaluates_once(cuda_dev, captures):
    """af2_tiny, dropout on, six steps whose draws (seed 17: 3, 1, 4, 2, 4,
    3) cover every n_recycle of 1..4: the graphed runner's losses,
    parameters and EMA lie no farther from an eager run's than a second
    eager run's do; one training graph per distinct draw, replayed with
    new batches, dropout keys and optimizer steps; the launches credited
    by replays equal the eager run's; two evaluations capture the eval
    engine's step once and agree."""
    model = _fold_model()

    def run(graphs):
        runner = TrainRunner(CFG, seed=17, device=cuda_dev, graphs=graphs,
                             model=copy.deepcopy(model).to(cuda_dev))
        ops.reset_launch_counts()
        runner.run(6)
        torch.cuda.synchronize()
        return runner, ops.launch_counts()

    (eager, counts), (again, _), (graphed, g_counts) = (
        run(False), run(False), run(None))
    assert graphed.graphs and graphed.history["n_recycle"] == [3, 1, 4, 2, 4, 3]
    assert graphed.train_compiles == len(captures) == 4
    assert g_counts == counts and counts["evo_attention_bwd"] > 0
    d_eager, d_graphed = _train_diff(eager, again), _train_diff(eager, graphed)
    for k in d_eager:
        assert d_graphed[k] <= d_eager[k], (k, d_graphed, d_eager)
    first, second = graphed.evaluate(), graphed.evaluate()
    assert graphed.eval_compiles == 1 and len(captures) == 5
    assert graphed.compile_misses == 5
    np.testing.assert_array_equal(first["coords"], second["coords"])
    assert np.isfinite(first["coords"]).all()


@pytest.mark.cuda
def test_dropout_mask_on_the_card_equals_the_cpu_mask(cuda_dev):
    """The hash dropout's integer arithmetic gives the same mask bits on the
    card as on the CPU, for the same words and path."""
    x = torch.ones((48, 80, 4))
    for dev_key, cpu_key in ((evo.dropout_key((5, 9), cuda_dev),
                              evo.dropout_key((5, 9), "cpu")),
                             ((5, 9), (5, 9))):
        for axis in (0, 1):
            rng = evo.fold_in(evo.fold_in(dev_key, 1), 3)
            want = evo.shared_dropout(x, 0.25, shared_axis=axis,
                                      rng=evo.fold_in(evo.fold_in(cpu_key, 1), 3),
                                      deterministic=False)
            got = evo.shared_dropout(x.to(cuda_dev), 0.25, shared_axis=axis,
                                     rng=rng, deterministic=False)
            assert torch.equal(got.cpu(), want)



@pytest.mark.cuda
def test_pipeline_batches_on_the_card_equal_the_cpu_batches(cuda_dev):
    """FASTA records, length-bucketed, 2 workers: the batches the pipeline
    places on the card, read on the consumer's stream as a captured step
    reads them (a copy into another buffer), equal the CPU pipeline's, and
    ``to_device`` (the step's input path) passes them through uncopied."""
    kw = dict(source=FastaSource(demo_fasta(CFG, n_records=8, seed=1), CFG),
              batch_size=1, seed=1, bucket_by_length=True,
              pad_to=bk.train_bucket(CFG))

    def take(pipe, read):
        out = []
        for step, batch in pipe:
            if pipe.device is not None:
                # the step's inputs are these tensors: no second copy
                placed = af2.to_device(batch, cuda_dev)
                assert all(placed[k] is v for k, v in batch.items())
            out.append((step, {k: read(v) for k, v in batch.items()}))
            if len(out) == 6:
                break
        pipe.close()
        return out

    want = take(DataPipeline(CFG, workers=0, **kw), np.asarray)
    got = take(DataPipeline(CFG, workers=2, device=cuda_dev, **kw),
               lambda v: v.clone())
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].is_cuda and torch.equal(g[k].cpu(),
                                                torch.from_numpy(w[k])), k


def _train_tensors(runner) -> dict:
    out = {}
    for part, tensors in (("params", dict(runner.model.named_parameters())),
                          ("mu", runner.state["opt"].mu),
                          ("nu", runner.state["opt"].nu),
                          ("ema", runner.state["ema"])):
        out.update({(part, k): t for k, t in tensors.items()})
    return out


@pytest.mark.cuda
def test_restore_into_a_captured_graph_replays_the_run(cuda_dev, captures,
                                                       tmp_path):
    """Graphed, one draw, FASTA records: 6 steps with checkpoints at 3 and
    6; the same runner restores step 3 into the tensors its graph reads
    (no tensor rebound, no new capture) and replays steps 3-5: its losses,
    parameters, moments and EMA equal the first pass's within the distance
    of two eager runs of the same steps."""
    source = FastaSource(demo_fasta(CFG, n_records=8, seed=1), CFG)
    model = _fold_model()

    def runner(graphs, sub):
        return TrainRunner(CFG, seed=1, recycle_sample=False, device=cuda_dev,
                           graphs=graphs,
                           model=copy.deepcopy(model).to(cuda_dev),
                           data_source=source, bucket_by_length=True,
                           ckpt_dir=str(tmp_path / sub), ckpt_every=3, keep=2)

    eager, again = runner(False, "e1"), runner(False, "e2")
    eager.run(6)
    again.run(6)
    bound = max([abs(x - y) for x, y in zip(eager.history["loss"],
                                             again.history["loss"])]
                + [(x.float() - y.float()).abs().max().item()
                   for x, y in zip(_train_tensors(eager).values(),
                                   _train_tensors(again).values())])
    g = runner(None, "g")
    g.run(6)
    assert g.train_compiles == len(captures) == 1
    final = {k: t.clone() for k, t in _train_tensors(g).items()}
    ptrs = {k: t.data_ptr() for k, t in _train_tensors(g).items()}
    assert g.restore(step=3) == 3 and g.step == 3
    assert {k: t.data_ptr() for k, t in _train_tensors(g).items()} == ptrs
    ops.reset_launch_counts()
    g.run(6)
    assert g.train_compiles == len(captures) == 1
    assert ops.launch_counts()["evo_attention_bwd"] == 3 * (
        4 * CFG.n_evoformer + 3 * CFG.n_extra_msa_blocks)
    assert max(abs(x - y) for x, y in zip(g.history["loss"][6:],
                                          g.history["loss"][3:6])) <= bound
    for k, t in _train_tensors(g).items():
        assert (t.float() - final[k].float()).abs().max().item() <= bound, k


@pytest.mark.cuda
def test_capture_survives_a_dead_graph_in_a_reference_cycle(cuda_dev):
    """A captured step whose last reference goes inside another step's
    capture, in a reference cycle: if the collector ran there (it runs
    whenever it is on and enough objects were made), the dead graph's
    ``cudaGraphExecDestroy`` would invalidate the capture and the next
    cuBLAS call in it fail.  The second step's replay equals its eager
    result."""
    w = torch.randn(64, 64, device=cuda_dev)
    first = graphs.CapturedStep(lambda x: x @ w)
    first(torch.randn(8, 64, device=cuda_dev))
    first.cycle = first
    box = [first]
    del first

    def fn(x):
        y = torch.tanh(x @ w)
        if box and torch.cuda.is_current_stream_capturing():
            box.clear()              # the first graph is garbage in a cycle
            if gc.isenabled():       # where an automatic collection may run
                gc.collect()
        return torch.tanh(y @ w)

    second = graphs.CapturedStep(fn)
    x = torch.randn(8, 64, device=cuda_dev)
    eager = second(x).clone()
    replay = second(x).clone()
    torch.cuda.synchronize()
    assert not box
    assert torch.equal(replay, eager)
