"""The port's dry run (``repro_torch.launch.dryrun``) and what it stands on,
on the CPU.

* The serving sharding rules (``serve.steps``) against the reference's.
* Every model builds on ``meta`` with the CPU-built module's keys, shapes
  and dtypes, and no draw; the protein sample's shape spec is the sample's.
* Each kernel's meta route gives its plain version's output shapes and
  dtypes (the CUDA kernels' own; ``chip_smoke.py`` phase 13 holds the
  routes to the kernels on the card); a kernel entry point on any device
  other than cpu / cuda / meta raises.
* The meta trace of an af2_tiny step (kernels K1-K5) counts the same aten
  ops and FLOPs as the same step on CPU tensors, and the same bytes but for
  the LayerNorm statistics, which torch's meta kernel (as CUDA's) keeps in
  fp32 where its CPU kernel keeps them in bf16.
* An af2_tiny cell on a 2x4 virtual mesh (bp 2 x dap 2 x data 2): its
  record, and one block's collectives by axis against
  ``analysis/roofline.py``'s DAP counts and the BP exchange.
* The sizing of every record of the reference's ``experiments/dryrun/``:
  the port's ``argument_bytes`` (and a training cell's ``alias_bytes``)
  equal the record's, or else the reference's own specs computed here (the
  record's compile pruned or aliased what the specs hold) and the cell is
  named under ROADMAP's Reference caveats.  No trace runs for these.

Every virtual world is opened and destroyed inside the test that uses it
(``virtual_world`` is a context manager), and each test checks that none is
left open.
"""
import dataclasses
import functools
import json
import math
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.core import config as jcore
from repro.data.protein import protein_sample as jax_protein_sample
from repro.models import get_model as jax_get_model
from repro.nn.partition import make_param_specs as jax_make_param_specs
from repro.serve import steps as jsteps
from repro.train import trainstep as jts
from repro.train.optim import adafactor_like as jax_adafactor

from repro_torch import configs as tconfigs
from repro_torch.analysis import cost as acost
from repro_torch.analysis import roofline as troof
from repro_torch.core import config as tcore
from repro_torch.core.model import AlphaFold2
from repro_torch.data.protein import protein_sample, protein_sample_spec
from repro_torch.kernels import cost as kcost
from repro_torch.kernels import meta as kmeta
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun as D
from repro_torch.models import get_model
from repro_torch.nn.partition import P
from repro_torch.parallel.mesh_utils import make_mesh, mesh_shape
from repro_torch.parallel.ranks import virtual_world
from repro_torch.serve import steps as tsteps
from repro_torch.train import trainstep as ts
from repro_torch.train.optim import adamw

import torch_threads  # noqa: F401  (one intra-op thread)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECORDS = sorted((ROOT / "experiments" / "dryrun").glob("*.json"))
ARCH_FILES = {a.replace("/", "_").replace(".", "_"): a
              for a in tconfigs.ARCH_IDS}
MESHES = {"single_pod": {"data": 16, "model": 16},
          "multi_pod": {"pod": 2, "data": 16, "model": 16}}
AF2_STATE_BYTES = 1_115_871_304


def _jp_to_p(spec):
    return P(*(tuple(e) if isinstance(e, (tuple, list)) else e
               for e in tuple(spec)))


# ---------------------------------------------------------------------------
# serving rules and the factored decode plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_cache_rules_match_reference(arch):
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for got, want in (
            (tsteps.cache_partition_rules(tcfg),
             jsteps.cache_partition_rules(jcfg)),
            (tsteps.cache_partition_rules_2d(tcfg, data_axes=("pod", "data",
                                                              "brep")),
             jsteps.cache_partition_rules_2d(jcfg, data_axes=("pod", "data",
                                                              "brep"))),
            (tsteps.cache_partition_rules_2d(tcfg),
             jsteps.cache_partition_rules_2d(jcfg))):
        assert [(r, s) for r, s in got] == [(r, _jp_to_p(s)) for r, s in want]
    assert {k: tuple(v) for k, v in tsteps.serve_batch_specs(tcfg).items()} \
        == {k: tuple(v) for k, v in jsteps.serve_batch_specs(jcfg).items()}


def _standin(extents):
    return types.SimpleNamespace(shape=dict(extents),
                                 axis_names=tuple(extents))


def _refactor(mesh, split):
    out = {}
    for name, ext in mesh.shape.items():
        if name in split:
            out.update(dict(split[name]))
        else:
            out[name] = ext
    return _standin(out)


def _jax_decode_plan(cfg, extents, monkeypatch):
    from repro.parallel import mesh_utils as jmu
    monkeypatch.setattr(jmu, "refactor_mesh", _refactor)
    mesh, tp, data = jsteps.decode_mesh_plan(cfg, _standin(extents))
    return tp, tuple(data), dict(mesh.shape)


@pytest.mark.parametrize("kind", ["single_pod", "multi_pod"])
def test_decode_mesh_plan_matches_reference(kind, monkeypatch):
    extents = MESHES[kind]
    with virtual_world(math.prod(extents.values())):
        base = make_mesh(tuple(extents.values()), tuple(extents))
        for arch in tconfigs.ARCH_IDS:
            cfg = tconfigs.get_config(arch)
            mesh, tp, data = tsteps.decode_mesh_plan(cfg, base)
            got = (tp, tuple(data), mesh_shape(mesh))
            want = _jax_decode_plan(jconfigs.get_config(arch), extents,
                                    monkeypatch)
            assert got == want, arch
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# meta construction
# ---------------------------------------------------------------------------

def _same_layout(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert (tuple(a[k].shape), a[k].dtype) == (tuple(b[k].shape),
                                                   b[k].dtype), k


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_lm_builds_on_meta(arch):
    cfg = tconfigs.get_smoke_config(arch)
    lm = get_model(cfg)
    on_meta = lm.init_params(cfg, device="meta")
    assert all(p.is_meta for p in on_meta.parameters())
    _same_layout(lm.init_params(cfg, device="cpu").state_dict(),
                 on_meta.state_dict())
    cache = lm.init_cache(cfg, 2, 16, device="meta")
    assert all(t.is_meta for t in cache.values())
    _same_layout(lm.init_cache(cfg, 2, 16, device="cpu"), cache)


def test_af2_builds_on_meta_with_no_draw(monkeypatch):
    cfg = tcore.af2_tiny()
    cpu = AlphaFold2(cfg, device="cpu").state_dict()

    def no_draw(*a, **k):
        raise AssertionError("a meta build drew a number")
    monkeypatch.setattr(torch.nn.init, "trunc_normal_", no_draw)
    monkeypatch.setattr(torch, "randn", no_draw)
    on_meta = AlphaFold2(cfg, device="meta")
    assert all(p.is_meta for p in on_meta.parameters())
    _same_layout(cpu, on_meta.state_dict())


def test_protein_sample_spec_is_the_sample():
    cfg = tcore.af2_tiny()
    sample = protein_sample(np.random.default_rng(0), cfg)
    spec = protein_sample_spec(cfg)
    assert list(sample) == list(spec)
    for k, v in sample.items():
        assert (v.shape, v.dtype) == spec[k], k


# ---------------------------------------------------------------------------
# the kernels' meta route
# ---------------------------------------------------------------------------

def _kernel_cases():
    g = torch.Generator().manual_seed(0)
    r = lambda *s, dt=torch.bfloat16: torch.randn(s, generator=g).to(dt)
    L, S, H, C = 3, 20, 2, 8
    q, k, v, gate, out, do = (r(L, S, H, C) for _ in range(6))
    bias = r(H, S, S)
    lse = r(L * H, S, dt=torch.float32)
    ri, rj, c_z, c = 12, 24, 16, 16
    xa, xb, xg = r(ri, rj, c_z), r(rj, rj, c_z), r(ri, rj, c_z)
    w = (r(c_z, 2 * c), r(2 * c), r(c_z, 2 * c), r(2 * c), r(c), r(c),
         r(c, c_z), r(c_z), r(c_z, c_z), r(c_z))
    s = r(ri, rj, c, dt=torch.float32)
    ds = r(ri, rj, c, dt=torch.float32)
    fq, fk, fv = r(2, 9, 4, 32), r(2, 11, 2, 32), r(2, 11, 2, 32)
    return {
        "K1": (kmeta.evo_attention_fwd, ref.evo_attention_ref,
               (q, k, v, bias, gate), {"return_lse": True}),
        "K1_nobias": (kmeta.evo_attention_fwd, ref.evo_attention_ref,
                      (q, k, v, None, gate), {}),
        "K2": (kmeta.evo_attention_bwd, ref.evo_attention_bwd_ref,
               (q, k, v, bias, gate, out, lse, do), {}),
        "K2_nogate": (kmeta.evo_attention_bwd, ref.evo_attention_bwd_ref,
                      (q, k, v, bias, None, out, lse, do), {}),
        "K3": (kmeta.triangle_mult_fwd, ref.triangle_mult_ref,
               (xa, xb, xg, *w), {"return_s": True}),
        "K4": (kmeta.triangle_mult_bwd_epilogue,
               ref.triangle_mult_bwd_epilogue_ref,
               (s, xg, xg, *w[4:]), {}),
        "K5": (kmeta.triangle_mult_bwd_dx, ref.triangle_mult_bwd_dx_ref,
               (ds, xa, xb, *w[:4]), {}),
        "K6": (kmeta.flash_attention_fwd, ref.flash_attention_ref,
               (fq, fk, fv, True), {}),
    }


def _layout(out):
    out = out if isinstance(out, tuple) else (out,)
    return [None if t is None else (tuple(t.shape), t.dtype) for t in out]


@pytest.mark.parametrize("name", list(_kernel_cases()))
def test_meta_route_matches_plain_shapes(name):
    meta_fn, plain, args, kwargs = _kernel_cases()[name]
    to_meta = lambda t: t.to("meta") if isinstance(t, torch.Tensor) else t
    got = meta_fn(*map(to_meta, args), **kwargs)
    assert all(t is None or t.is_meta
               for t in (got if isinstance(got, tuple) else (got,)))
    assert _layout(got) == _layout(plain(*args, **kwargs))


CSRC = pathlib.Path(kcost.__file__).resolve().parents[1] / "csrc"
# (C source, C name, kernels/cost.py name) of every tile constant the
# scratch sizes use, and the literals the C sizing expressions hold inline
SCRATCH_CONSTANTS = (
    ("evo_attention_bwd.cu", "TQ", "_K2_TQ"),
    ("evo_attention_bwd.cu", "RT", "_K2_RT"),
    ("tile_mma.cuh", "BM", "_BM"), ("tile_mma.cuh", "BN", "_BN"),
    ("tile_mma.cuh", "BK", "_BK"), ("tile_mma.cuh", "PAD", "_PAD"),
    ("triangle_mult_bwd.cu", "OT", "_OT"),
    ("triangle_mult_bwd.cu", "OP", "_OP"),
    ("triangle_mult_bwd.cu", "OUTER_BLOCKS", "_OUTER_BLOCKS"),
    ("triangle_mult_bwd.cu", "EP", "_EP"),
    ("triangle_mult_bwd.cu", "EPI_WARPS", "_EPI_WARPS"),
    ("triangle_mult_bwd.cu", "EPI_ROWS", "_EPI_ROWS"),
    ("triangle_mult_bwd.cu", "EPI_MAX_BLOCKS", "_EPI_MAX_BLOCKS"))
SCRATCH_LITERALS = (
    ("evo_attention_bwd.cu", "(2048 + per_chunk - 1) / per_chunk"),
    ("evo_attention_bwd.cu", "(biased ? 132 : 264) / tiles"),
    ("evo_attention_bwd.cu", "static constexpr int NW = sizeof(BT) == 2 ? 4 : 2;"))


@pytest.mark.parametrize("src,c_name,py_name", SCRATCH_CONSTANTS,
                         ids=[c for _, c, _ in SCRATCH_CONSTANTS])
def test_scratch_constants_are_the_kernels(src, c_name, py_name):
    """The wrappers size K2-K5's scratch by kernels/cost.py; its tile
    constants must be the C sources' (each launch refuses less scratch than
    its layout takes, but only on the card)."""
    text = (CSRC / src).read_text()
    found = re.findall(rf"\b{c_name}\s*=\s*(\d+)\s*[;,]", text)
    assert found, f"{c_name} not found in {src}"
    assert {int(v) for v in found} == {getattr(kcost, py_name)}


def test_scratch_literals_are_the_kernels():
    for src, expr in SCRATCH_LITERALS:
        assert expr in (CSRC / src).read_text(), (src, expr)


def test_kernel_entry_raises_on_other_devices():
    fake = types.SimpleNamespace(device=torch.device("cpu"))
    fake.device = types.SimpleNamespace(type="xpu")
    with pytest.raises(ValueError, match="no kernel for device type 'xpu'"):
        ops._route(None, None, None, fake)
    t = torch.zeros(1)
    assert ops._route("k", "plain", "meta", t) == "plain"
    assert ops._route("k", "plain", "meta", t.to("meta")) == "meta"


# ---------------------------------------------------------------------------
# the meta trace against the CPU trace
# ---------------------------------------------------------------------------

def _count_af2_step(device):
    cfg = tcore.with_kernels(tcore.af2_tiny())
    model = AlphaFold2(cfg, device=device)
    opt = adamw(1e-3, clip_norm=0.1)
    state = ts.init_state(model, opt)
    batch = {k: torch.as_tensor(v).to(device) for k, v in
             tcore_batch(cfg).items()}
    key = torch.zeros(2, dtype=torch.int64, device=device)
    step = torch.ones((), device=device)
    body = ts.make_step_body(cfg, opt)
    args = D._state_tensors(state) + list(batch.values()) + [step]
    with acost.counting(args) as trace:
        body(state, batch, key, step, 1)
    return trace


@functools.lru_cache(maxsize=None)
def tcore_batch(cfg):
    from repro_torch.data.protein import protein_batch
    return protein_batch(0, 0, 1, cfg)


def test_meta_trace_counts_the_cpu_trace():
    cpu, meta = _count_af2_step("cpu"), _count_af2_step("meta")
    assert meta.kernels == cpu.kernels
    assert set(meta.kernels) == set(ops.KERNELS) - {"flash_attention_fwd"}
    assert meta.ops == cpu.ops
    assert meta.aten_flops == cpu.aten_flops
    assert meta.kernel_flops == cpu.kernel_flops > 0
    assert meta.kernel_bytes == cpu.kernel_bytes
    stats = {"native_layer_norm", "native_layer_norm_backward"}
    for name in set(cpu.op_bytes) | set(meta.op_bytes):
        if name in stats:
            assert meta.op_bytes[name] > cpu.op_bytes[name]
        else:
            assert meta.op_bytes[name] == cpu.op_bytes[name], name
    assert meta.argument_bytes == cpu.argument_bytes
    assert meta.peak > meta.argument_bytes


# ---------------------------------------------------------------------------
# a cell on a virtual mesh
# ---------------------------------------------------------------------------

def test_af2_cell_on_a_small_virtual_mesh(monkeypatch):
    """An af2_tiny cell on a 2x4 virtual mesh, bp 2 x dap 2 x data 2, remat
    none: the record's fields, the probes' extrapolation, and one block's
    collectives by axis (the 2 + 1 probe less the 1 + 1) on each branch."""
    traced = []
    trace = D.trace_af2_step

    def keep(*args, **kwargs):
        traced.append(trace(*args, **kwargs))
        return traced[-1]
    monkeypatch.setattr(D, "trace_af2_step", keep)
    rec = D.run_af2_cell("tiny", False, bp=2, dap=2, global_batch=2,
                         remat="none", mesh=((2, 4), ("data", "model")))
    assert not dist.is_initialized()
    assert rec["status"] == "ok" and rec["devices"] == 8
    assert {r: v["rank"] for r, v in rec["roles"].items()} == {
        "branch0": 0, "branch1": 2}
    assert set(rec["full"]) >= {"per_device_flops", "per_device_bytes",
                                "collectives", "collective_bytes_static",
                                "memory", "n_devices"}
    assert set(rec["probe"]) >= {"l1", "l2", "extrapolated"}
    ex = rec["probe"]["extrapolated"]
    for k in ("per_device_flops", "collective_bytes_static"):
        assert abs(ex[k] - rec["full"][k]) <= 0.02 * rec["full"][k], k
    mem = rec["full"]["memory"]
    assert mem["peak_bytes_estimate"] > mem["argument_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")

    # per role: the full trace, then the probes l1, l2, l2_extra
    def block(role):
        l1, l2 = (traced[4 * role + i]["collectives_by_axis"] for i in (1, 2))
        return {ax: {k: v["count"] - l1[ax].get(k, {"count": 0})["count"]
                     for k, v in table.items()} for ax, table in l2.items()}
    msa, pair = block(0), block(1)
    # each branch issues its own DAP collectives, forward and backward (a
    # gather's transpose is a reduce-scatter, an all-to-all's the inverse
    # all-to-all); the fused triangle update's incoming side re-shards
    # nothing, one all-to-all less than the 'reference' impl the
    # roofline's pair count holds
    fwd = lambda t: t.get("all-gather", 0) + t.get("all-to-all", 0) // 2
    assert fwd(msa["dap"]) == troof.N_DAP_COLLECTIVES_MSA
    assert fwd(pair["dap"]) == troof.N_DAP_COLLECTIVES_PAIR - 1
    for t in (msa["dap"], pair["dap"]):
        assert t["reduce-scatter"] == t["all-gather"]
    # BP: the block-end exchange and its backward all-reduce
    assert msa["branch"] == pair["branch"] == {"all-reduce": 2}
    # the data axis reduces gradients once a step, not once a block
    assert msa["data"] == {"all-reduce": 0}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_and_its_views(multi_pod, monkeypatch):
    from repro_torch.launch import mesh as lmesh
    monkeypatch.delenv("REPRO_DRYRUN_MESH", raising=False)
    want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    with virtual_world(math.prod(want.values())):
        mesh = lmesh.make_production_mesh(multi_pod=multi_pod)
        assert mesh_shape(mesh) == want
        assert mesh_shape(lmesh.production_mesh_from_env(multi_pod)) == want
        assert lmesh.dp_axes_of(mesh) == tuple(a for a in ("pod", "data")
                                               if a in want)
        view = lmesh.af2_logical_mesh(mesh, bp=2, dap=8)
        assert mesh_shape(view) == {**{a: e for a, e in want.items()
                                       if a != "model"},
                                    "branch": 2, "dap": 8}
        with pytest.raises(ValueError, match="model axis"):
            lmesh.af2_logical_mesh(mesh, bp=2, dap=4)
    monkeypatch.setenv("REPRO_DRYRUN_MESH", "4x2")
    with virtual_world(8):
        assert mesh_shape(lmesh.production_mesh_from_env(multi_pod)) == {
            "data": 4, "model": 2}
    assert not dist.is_initialized()


def test_virtual_worlds_in_turn():
    for n in (256, 512):
        with virtual_world(n):
            assert dist.get_world_size() == n
            assert dist.get_backend() == "fake"
            with pytest.raises(RuntimeError, match="already open"):
                with virtual_world(2):
                    pass
        assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# LM cells: sized and traced at the production mesh, and at a model
# extent of 1
# ---------------------------------------------------------------------------

def test_lm_cell_sized_at_production_mesh_and_cli(tmp_path, monkeypatch):
    """glm4-9b decode_32k on the (16, 16) mesh: sized from the reference's
    specs, and traced (tensor-parallel over 'model' 16).  The traced
    arguments exceed the sized ones by the weights alone: a serving rank
    holds its 'model' slices whole over 'data' (ROADMAP "Reference
    caveats") where the specs also cut them over 'data' (``cfg.fsdp``)."""
    from repro_torch.models import get_model
    from repro_torch.nn.partition import make_param_specs
    from repro_torch.train.trainstep import lm_stacked, param_dict
    monkeypatch.setattr(D, "OUT_DIR", tmp_path)
    D.main(["--arch", "glm4-9b", "--shape", "decode_32k", "--no-probes"])
    rec = json.loads((tmp_path / "glm4-9b__decode_32k__single_pod.json")
                     .read_text())
    assert rec["status"] == "ok" and "trace_skipped" not in rec
    sized = rec["sized"]
    assert sized["argument_bytes"] == 10_885_985_344
    full = rec["full"]
    assert full["per_device_flops"] > 0
    assert full["collectives_by_axis"]["model"]["all-reduce"]["count"] > 0
    cfg = tconfigs.get_config("glm4-9b")
    lm = get_model(cfg)
    params = param_dict(lm.init_params(cfg, device="meta"))
    whole = D.tree_bytes(params, make_param_specs(
        params, lm.partition_rules(cfg), stacked=lm_stacked(cfg)),
        {"data": 1, "model": 16}) // 2     # the init's fp32 -> bf16
    assert full["memory"]["argument_bytes"] == (
        sized["argument_bytes"] - sized["parts"]["params"] + whole)
    assert full["memory"]["alias_bytes"] == sized["alias_bytes"]


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_lm_cell_traced_at_model_extent_1(shape, monkeypatch):
    monkeypatch.setenv("REPRO_DRYRUN_MESH", "2x1")
    cfg = tconfigs.get_smoke_config("glm4-9b")
    probes = shape != "train_4k"
    rec = D.run_lm_cell("glm4-9b", shape, False, cfg_override=cfg,
                        probes=probes)
    assert not dist.is_initialized()
    assert rec["status"] == "ok"
    full = rec["full"]
    assert full["per_device_flops"] > 0 and full["aten_ops"] > 0
    if shape == "train_4k":
        assert full["collectives_by_axis"]["data"]["all-reduce"]["count"] > 0
    mem = full["memory"]
    assert mem["peak_bytes_estimate"] >= mem["argument_bytes"] > 0
    if probes:
        ex = rec["probe"]["extrapolated"]["per_device_flops"]
        assert abs(ex - full["per_device_flops"]) <= \
            0.02 * full["per_device_flops"]


# ---------------------------------------------------------------------------
# sizing against the reference's records
# ---------------------------------------------------------------------------

def _local_bytes(shape, itemsize, spec, extents):
    return D.local_bytes(tuple(shape), itemsize, _jp_to_p(spec), extents)


def _tree_bytes(shapes, specs, extents):
    leaves = jax.tree_util.tree_leaves(shapes)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(spec_leaves)
    return sum(_local_bytes(s.shape, s.dtype.itemsize, sp, extents)
               for s, sp in zip(leaves, spec_leaves))


@functools.lru_cache(maxsize=None)
def _jax_params(cfg):
    model = jax_get_model(cfg)
    return jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0),
                                                    cfg))


def _jax_cell_bytes(cfg, shape, extents, monkeypatch):
    """(argument bytes, state bytes) of a cell from the reference's own
    specs: its ``make_lm_train_step`` state shardings or ``build_lm_step``
    serving layout, on a mesh stand-in (only extents are read)."""
    model = jax_get_model(cfg)
    mesh = _standin(extents)
    data_axes = tuple(a for a in ("pod", "data") if a in extents)
    pshapes = _jax_params(cfg)
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": (b, s)}
    if cfg.family in ("audio", "vlm"):
        batch["frames" if cfg.family == "audio" else "patches"] = (
            (b, cfg.n_frontend_tokens, cfg.frontend_dim))
        if cfg.family == "vlm":
            batch["tokens"] = (b, s - cfg.n_frontend_tokens)
    itemsize = lambda k: 2 if k in ("frames", "patches") else 4
    if shape.kind == "train":
        monkeypatch.setattr(jts, "NamedSharding", lambda m, sp: sp)
        opt = jax_adafactor(1e-4, clip_norm=1.0)
        _, state_shardings, _ = jts.make_lm_train_step(
            model, cfg, opt, mesh, data_axes=data_axes)
        oshapes = jax.eval_shape(lambda: opt.init(jax.tree_util.tree_map(
            lambda x: jnp.zeros(x.shape, x.dtype), pshapes)))
        shd = state_shardings(pshapes, oshapes)
        state = (_tree_bytes(pshapes, shd["params"], extents)
                 + _tree_bytes(oshapes, shd["opt"], extents))
        batch["labels"] = batch["tokens"]
        dspec = JP(data_axes if len(data_axes) > 1 else data_axes[0])
        inputs = sum(_local_bytes(v, itemsize(k), dspec, extents)
                     for k, v in batch.items())
        return state + inputs, state
    tp_axis = "model"
    if shape.kind == "decode" and cfg.factored_decode:
        from repro.parallel import mesh_utils as jmu
        monkeypatch.setattr(jmu, "refactor_mesh", _refactor)
        mesh, tp_axis, data_axes = jsteps.decode_mesh_plan(cfg, mesh)
    ext = dict(mesh.shape)
    pspecs = jax_make_param_specs(
        pshapes, model.partition_rules(cfg, tp_axis=tp_axis))
    cshapes = jax.eval_shape(lambda: model.init_cache(cfg, b, s + 1))
    crules = (jsteps.cache_partition_rules_2d(cfg,
                                              data_axes=tuple(data_axes))
              if isinstance(tp_axis, tuple) else
              jsteps.cache_partition_rules(cfg))
    cache = _tree_bytes(cshapes, jax_make_param_specs(cshapes, crules), ext)
    data = data_axes if len(data_axes) > 1 else data_axes[0]
    if shape.kind == "prefill":
        if cfg.family not in ("audio", "vlm"):
            batch = {"tokens": batch["tokens"]}
    else:
        batch = {"tokens": (b, 1)}
    inputs = sum(_local_bytes(v, itemsize(k), JP(data, *[None] * (len(v) - 1)),
                              ext) for k, v in batch.items())
    return _tree_bytes(pshapes, pspecs, ext) + cache + inputs, cache


def _record_cell(path):
    arch_s, shape, rest = path.stem.split("__")
    kind = "multi_pod" if rest.startswith("multi_pod") else "single_pod"
    over = {}
    if "_opt_" in rest:
        for name in rest.split("_opt_")[1].split("-"):
            over.update(D.OPT_OVERRIDES[name])
    return ARCH_FILES[arch_s], shape, kind, over


def _caveats() -> str:
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("### Reference caveats")
    return text[start:text.index("\n### ", start + 1)]


LM_RECORDS = [p for p in RECORDS if not p.name.startswith("af2")]
AF2_RECORDS = [p for p in RECORDS if p.name.startswith("af2")]


@pytest.mark.parametrize("path", LM_RECORDS, ids=lambda p: p.stem)
def test_lm_sizing_matches_reference_record(path, monkeypatch):
    arch, shape_name, kind, over = _record_cell(path)
    shape = tconfigs.SHAPES[shape_name]
    extents = MESHES[kind]
    got = D.size_lm_cell(dataclasses.replace(tconfigs.get_config(arch),
                                             **over), shape, extents)
    want = json.loads(path.read_text())["full"]["memory"]
    same = got["argument_bytes"] == want["argument_bytes"] and (
        shape.kind != "train" or got["alias_bytes"] == want["alias_bytes"])
    if same:
        return
    args, state = _jax_cell_bytes(
        dataclasses.replace(jconfigs.get_config(arch), **over), shape,
        extents, monkeypatch)
    assert got["argument_bytes"] == args
    assert got["alias_bytes"] == state
    assert path.stem in _caveats(), f"{path.stem} is not under the caveats"


@functools.lru_cache(maxsize=None)
def _af2_sizes():
    """(the port's AF2 state bytes, the reference's sample leaves)."""
    _, _, state = D.af2_state(tcore.af2_initial(), adamw(1e-3, clip_norm=0.1))
    return state, jax.eval_shape(lambda: jax_protein_sample(
        jax.random.PRNGKey(0), jcore.af2_initial()))


@pytest.mark.parametrize("path", AF2_RECORDS, ids=lambda p: p.stem)
def test_af2_sizing_matches_reference_record(path):
    rec = json.loads(path.read_text())
    mem = rec["full"]["memory"]
    state, jsample = _af2_sizes()
    assert state == mem["alias_bytes"] == AF2_STATE_BYTES
    n_local = 128 // (32 if rec["mesh"] == "multi_pod" else 16)
    batch = D.af2_batch(tcore.af2_initial(), n_local)
    got = sum(acost._nbytes(t) for t in batch.values())
    print(f"{path.stem}: batch {got} bytes, argument - alias "
          f"{mem['argument_bytes'] - mem['alias_bytes']}")
    differ = [k for k, t in batch.items()
              if str(t.dtype).replace("torch.", "") != str(jsample[k].dtype)]
    print("leaves whose dtype differs from the reference's:", differ)
    assert got == mem["argument_bytes"] - mem["alias_bytes"]
    assert not differ
