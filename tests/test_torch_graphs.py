"""The port's captured serving steps (``repro_torch.graphs``): the sample-
cycle ``FoldEngine`` captures, the ``DecodeEngine`` steps' static buffers,
the launch credits of a replay, and (on the card) graphed against eager
serving, bit for bit.

CPU cases run at af2_tiny and glm4-9b's reduced config; the ``cuda`` cases
skip without a card (the ``cuda_dev`` fixture decides at run time).  On the
card: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_graphs.py``.

Tolerance: none.  A graph replays the launches of the eager step it was
captured from, in the same order on the same inputs, and no kernel sums
with atomics, so graphed and eager results are compared for equality.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch import configs, graphs
from repro_torch.core import model as af2
from repro_torch.core.config import af2_tiny, with_kernels
from repro_torch.data.synthetic import make_fold_requests
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import ops
from repro_torch.models import dense, get_model
from repro_torch.models.lmconfig import with_kernels as lm_with_kernels
from repro_torch.serve import fold_steps as fs
from repro_torch.serve.engine import DecodeEngine, Request
from repro_torch.serve.fold_engine import FoldEngine

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


def test_fold_engine_loads_weights_into_its_storage():
    """load_weights copies into the cast module the graphs read: same
    tensors, same storage, the new values in the engine's dtype."""
    engine = FoldEngine(CFG, _fold_model(seed=0), device="cpu")
    params = list(engine.params.parameters())
    ptrs = [p.data_ptr() for p in params]
    new = _fold_model(seed=4)
    engine.load_weights(new)
    assert list(engine.params.parameters()) == params
    assert [p.data_ptr() for p in params] == ptrs
    for got, src in zip(params, new.parameters()):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, src.to(torch.bfloat16))


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
