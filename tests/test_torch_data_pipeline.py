"""The port's training input pipeline (``repro_torch.data``: ingest,
bucketing, pipeline, loader) against the JAX package's, at af2_tiny shapes.

Parity is byte for byte: the same keys, dtypes, shapes and bytes for every
array (parsers, ``featurize_record``, the bucket schedule, padding and the
record-path stream at 0, 1 and 3 workers; the reference runs without a
device stage, ``sharding=None``).  The lifecycle and failure cases run on
the port alone.  Every test that starts threads consumes them on a helper
thread joined with a timeout, so a regression fails instead of hanging.
The device stage's ``cuda`` case is in ``tests/test_torch_graphs.py``,
which imports no JAX and so runs on the card.
"""
import threading
import time

import numpy as np
import pytest

from repro.core.config import af2_tiny as jaf2_tiny
from repro.data import bucketing as jbk
from repro.data import ingest as jingest
from repro.data.pipeline import DataPipeline as JaxDataPipeline

from repro_torch.core.config import af2_tiny
from repro_torch.data import bucketing as bk
from repro_torch.data import ingest
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.pipeline import (TRAIN_BATCH_KEYS, DataPipeline,
                                       HostWorkerPool, WorkerFailure)
from repro_torch.data.protein import protein_batch

import torch_threads  # noqa: F401  (one intra-op thread)

CFG, JCFG = af2_tiny(), jaf2_tiny()
TIMEOUT = 60.0

MMCIF_LITE = """\
data_demo
loop_
_atom_site.group_PDB
_atom_site.label_atom_id
_atom_site.label_comp_id
_atom_site.label_seq_id
_atom_site.Cartn_x
_atom_site.Cartn_y
_atom_site.Cartn_z
ATOM N   MET 1 0.0 0.0 0.0
ATOM CA  MET 1 1.0 2.0 3.0
ATOM CA  ALA 2 4.8 2.0 3.0
HETATM CA  HOH 3 9.9 9.9 9.9
ATOM CA  GLY 4 8.6 2.0 3.0
ATOM CA  XYZ 5 12.4 2.5 3.1
#
"""


def _same_bytes(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), what


def _same_dicts(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        _same_bytes(got[k], want[k], k)


def _in_thread(fn, timeout=TIMEOUT):
    """``fn()`` on a daemon thread, joined with a timeout: (result, error)."""
    box = {}

    def target():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 — handed to the test
            box["err"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "the consumer hung"
    return box.get("out"), box.get("err")


def _collect(pipe, n):
    def take():
        out = []
        for step, batch in pipe:
            out.append((step, {k: np.asarray(v) for k, v in batch.items()}))
            if len(out) >= n:
                break
        pipe.close()
        return out
    out, err = _in_thread(take)
    if err is not None:
        raise err
    return out


def _same_streams(a, b):
    assert [s for s, _ in a] == [s for s, _ in b]
    for (_, x), (_, y) in zip(a, b):
        _same_dicts(x, y)


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", [">a desc\nACDE\nFGH\n\n>b\n  MKV  \n",
                                  ">x\nAC-DX.Z\n>y len=3\nwyv\n"])
def test_parse_fasta_matches_reference(text):
    assert ingest.parse_fasta(text) == jingest.parse_fasta(text)
    for seq in ("ACDEFGH", "AC-DX.Z", "wyv"):
        _same_bytes(ingest.aa_ids(seq), jingest.aa_ids(seq), seq)
    for mod in (ingest, jingest):
        with pytest.raises(ValueError):
            mod.parse_fasta("ACDE\n>late header\n")


def test_parse_mmcif_lite_matches_reference():
    seq, coords = ingest.parse_mmcif_lite(MMCIF_LITE)
    want_seq, want_coords = jingest.parse_mmcif_lite(MMCIF_LITE)
    assert seq == want_seq == "MAGX"
    _same_bytes(coords, want_coords)
    for mod in (ingest, jingest):
        with pytest.raises(ValueError):
            mod.parse_mmcif_lite("data_x\nloop_\n_foo.bar\n1\n")


def _sources(mod, cfg):
    seq, coords = mod.parse_mmcif_lite(MMCIF_LITE)
    fasta = mod.demo_fasta(cfg, n_records=6, seed=3) + f">cif\n{seq}\n"
    return {
        "fasta": mod.FastaSource(fasta, cfg, structures={"cif": coords}),
        "synthetic": mod.SyntheticSource(cfg, seed=4, n_records=6,
                                         vary_length=True),
        "synthetic_full": mod.SyntheticSource(cfg, seed=5, n_records=3),
    }


@pytest.mark.parametrize("kind", ["fasta", "synthetic", "synthetic_full"])
def test_featurize_record_matches_reference(kind):
    src, jsrc = _sources(ingest, CFG)[kind], _sources(jingest, JCFG)[kind]
    assert len(src) == len(jsrc)
    for idx in range(len(src)):
        assert src.record_length(idx) == jsrc.record_length(idx)
        rec, jrec = src.record(idx), jsrc.record(idx)
        assert (rec.name, rec.seq, rec.msa) == (jrec.name, jrec.seq, jrec.msa)
        _same_bytes(rec.coords, jrec.coords)
        for seed, step in ((0, 0), (7, 12)):
            _same_dicts(ingest.featurize_record(rec, CFG, seed=seed,
                                                step=step, idx=idx),
                        jingest.featurize_record(jrec, JCFG, seed=seed,
                                                 step=step, idx=idx))
    # a record without coordinates or MSA rows: the digest-seeded chain
    bare = ingest.ProteinRecord(name="bare", seq="MKVLAAGICW")
    jbare = jingest.ProteinRecord(name="bare", seq="MKVLAAGICW")
    _same_dicts(ingest.featurize_record(bare, CFG, seed=1, step=2, idx=3),
                jingest.featurize_record(jbare, JCFG, seed=1, step=2, idx=3))


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,batch_size,by_length,start", [
    (0, 1, True, 0), (3, 2, True, 5), (11, 3, False, 2), (7, 2, False, 0)])
def test_bucket_schedule_plans_match_reference(seed, batch_size, by_length,
                                               start):
    lengths = [int(x) for x in
               np.random.default_rng(seed).integers(4, CFG.n_res + 1, 13)]
    buckets = bk.length_bucket_table(CFG)
    jbuckets = jbk.length_bucket_table(JCFG)
    assert [tuple(vars(b).values()) for b in buckets] == \
        [tuple(vars(b).values()) for b in jbuckets]
    sched = bk.BucketSchedule(lengths, buckets, seed=seed,
                              batch_size=batch_size, bucket_by_length=by_length)
    jsched = jbk.BucketSchedule(lengths, jbuckets, seed=seed,
                                batch_size=batch_size,
                                bucket_by_length=by_length)
    assert sched.per_epoch == jsched.per_epoch
    # resumed at ``start``, across an epoch boundary
    for step in range(start, start + 2 * sched.per_epoch + 1):
        p, jp = sched.batch_plan(step), jsched.batch_plan(step)
        assert p.indices == jp.indices
        assert (p.bucket.n_res, p.bucket.n_seq, p.bucket.n_extra_seq) == \
            (jp.bucket.n_res, jp.bucket.n_seq, jp.bucket.n_extra_seq)
    for n in (1, 5, CFG.n_res):
        assert bk.bucket_for_length(buckets, n).n_res == \
            jbk.bucket_for_length(jbuckets, n).n_res
    with pytest.raises(ValueError):
        bk.bucket_for_length(buckets, CFG.n_res + 1)


def test_pad_record_and_stack_batch_match_reference():
    src, jsrc = _sources(ingest, CFG)["fasta"], _sources(jingest, JCFG)["fasta"]
    bucket, jbucket = bk.train_bucket(CFG), jbk.train_bucket(JCFG)
    padded, jpadded = [], []
    for idx in range(len(src)):
        feats = ingest.featurize_record(src.record(idx), CFG, seed=2, idx=idx)
        jfeats = jingest.featurize_record(jsrc.record(idx), JCFG, seed=2,
                                          idx=idx)
        padded.append(bk.pad_record_to_bucket(feats, bucket))
        jpadded.append(jbk.pad_record_to_bucket(jfeats, jbucket))
        _same_dicts(padded[-1], jpadded[-1])
    assert min(src.record_length(i) for i in range(len(src))) < CFG.n_res
    _same_dicts(bk.stack_batch(padded), jbk.stack_batch(jpadded))


# ---------------------------------------------------------------------------
# the record-path stream
# ---------------------------------------------------------------------------

_REFERENCE_STREAMS: dict = {}


def _pipelines(kind, by_length, workers):
    src, jsrc = _sources(ingest, CFG)[kind], _sources(jingest, JCFG)[kind]
    kw = dict(batch_size=2, seed=9, bucket_by_length=by_length)
    port = DataPipeline(CFG, source=src, workers=workers,
                        pad_to=bk.train_bucket(CFG), **kw)
    ref = JaxDataPipeline(JCFG, source=jsrc, workers=0,
                          pad_to=jbk.train_bucket(JCFG), sharding=None, **kw)
    return port, ref


@pytest.mark.parametrize("workers", [0, 1, 3])
@pytest.mark.parametrize("by_length", [True, False])
@pytest.mark.parametrize("kind", ["fasta", "synthetic"])
def test_record_pipeline_stream_matches_reference(kind, by_length, workers):
    port, ref = _pipelines(kind, by_length, workers)
    key = (kind, by_length)
    if key not in _REFERENCE_STREAMS:
        _REFERENCE_STREAMS[key] = _collect(ref, 7)
    got = _collect(port, 7)
    _same_streams(got, _REFERENCE_STREAMS[key])
    assert list(got[0][1]) == list(TRAIN_BATCH_KEYS)
    if workers == 0:         # no lookahead: the same batches accounted
        assert port.report.bucket_counts == ref.report.bucket_counts


def test_compat_pipeline_is_protein_batch():
    got = _collect(DataPipeline(CFG, batch_size=2, seed=11, workers=2), 4)
    assert [s for s, _ in got] == [0, 1, 2, 3]
    for step, batch in got:
        _same_dicts(batch, protein_batch(11, step, 2, CFG))


def test_device_stage_is_off_on_the_cpu():
    """``device`` None or the CPU: the host batches come out as numpy."""
    for device in (None, "cpu"):
        pipe = DataPipeline(CFG, seed=1, workers=1, device=device)
        assert pipe.device is None
        (step, batch), = _collect(pipe, 1)
        assert all(isinstance(v, np.ndarray) for v in batch.values())
        assert pipe.report.transfer_s == 0.0


# ---------------------------------------------------------------------------
# lifecycle and failures (the port alone)
# ---------------------------------------------------------------------------

def _record_pipe(start_step=0, workers=3):
    src = ingest.SyntheticSource(CFG, seed=2, n_records=9, vary_length=True)
    return DataPipeline(CFG, source=src, batch_size=2, seed=2,
                        start_step=start_step, workers=workers,
                        bucket_by_length=True, pad_to=bk.train_bucket(CFG))


def test_pipeline_one_live_iteration_close_reiterate_and_resume():
    first = _collect(_record_pipe(), 6)
    pipe = _record_pipe()
    it = iter(pipe)
    with pytest.raises(RuntimeError, match="already being iterated"):
        iter(pipe)
    pipe.close()
    pipe.close()                         # idempotent
    _same_streams(_collect(pipe, 6), first)    # close -> re-iterate
    del it
    # resumed at step 3: the fresh run's tail, bit for bit
    _same_streams(_collect(_record_pipe(start_step=3, workers=1), 3),
                  first[3:])
    with pytest.raises(ValueError, match="record source"):
        DataPipeline(CFG, bucket_by_length=True)


def test_pipeline_worker_exception_reraised_at_its_step():
    def make_batch(step):
        if step == 3:
            raise ValueError("boom at 3")
        return protein_batch(0, step, 1, CFG)

    pipe = DataPipeline(CFG, make_batch=make_batch, workers=2)
    got = []

    def consume():
        for step, _ in pipe:
            got.append(step)

    _, err = _in_thread(consume)
    assert isinstance(err, RuntimeError) and "failed at step 3" in str(err)
    assert isinstance(err.__cause__, ValueError)
    assert got == [0, 1, 2]          # the steps before it still yield


def test_pipeline_report_accounts_steps():
    pipe = _record_pipe(workers=2)
    _collect(pipe, 5)
    d = pipe.report.as_dict()
    assert d["steps"] >= 5 and 0.0 < d["mean_fill"] < 1.0
    assert d["stall_ms_per_step"] >= 0.0 and d["featurize_ms_per_step"] > 0.0
    assert sum(d["buckets"].values()) == pipe.report.batches


def test_host_worker_pool_inline_and_threaded_failures():
    def fn(x):
        if x < 0:
            raise ValueError("bad item")
        return x * 2

    inline = HostWorkerPool(fn, workers=0)
    inline.submit(3)
    assert inline.poll() == [6]
    inline.submit(-1)
    (fail,) = inline.poll()
    assert isinstance(fail, WorkerFailure) and fail.item == -1
    inline.submit(-1)
    with pytest.raises(ValueError, match="bad item"):
        inline.poll(raise_failures=True)

    pool = HostWorkerPool(fn, workers=2, cap=4)
    for x in (1, 2, -1, 3):
        pool.submit(x)
    got, deadline = [], time.monotonic() + TIMEOUT
    while len(got) < 4 and time.monotonic() < deadline:
        got.extend(pool.poll(block=True, timeout=1.0))
    pool.close()
    vals = [g for g in got if not isinstance(g, WorkerFailure)]
    assert sorted(vals) == [2, 4, 6] and len(got) == 4


def test_sharded_loader_worker_exception_propagates():
    def make_batch(step):
        if step == 2:
            raise RuntimeError("synthetic corruption at step 2")
        return {"x": np.full((2,), step)}

    loader = ShardedLoader(make_batch, start_step=0, prefetch=2)
    got = []

    def consume():
        for step, _ in loader:
            got.append(step)

    _, err = _in_thread(consume)
    assert isinstance(err, RuntimeError) and "step 2" in str(err)
    assert got == [0, 1]


def test_sharded_loader_order_guard_and_stale_iterator():
    def run():
        loader = ShardedLoader(lambda s: {"x": np.full((1,), s)}, prefetch=2)
        it1 = iter(loader)
        assert next(it1)[0] == 0
        with pytest.raises(RuntimeError, match="already being iterated"):
            next(iter(loader))
        loader.close()
        loader.close()                   # idempotent
        it2 = iter(loader)
        assert [next(it2)[0] for _ in range(3)] == [0, 1, 2]
        it1.close()                      # late finalization of the old one
        assert next(it2)[0] == 3         # the new iteration is still alive
        loader.close()

    _, err = _in_thread(run)
    if err is not None:
        raise err

