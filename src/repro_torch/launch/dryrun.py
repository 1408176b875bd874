"""The dry run: size and trace one rank's step of a cell — an (arch x shape
x mesh) — without allocating, and record its memory, operations, bytes,
collectives and roofline (counterpart of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell on 512 fake XLA host devices
from ``ShapeDtypeStruct`` stand-ins.  The port runs one process per rank,
so the dry run runs rank 0's step itself: on ``meta`` tensors (shapes and
dtypes, no storage) inside a virtual world of the cell's rank count
(``parallel.ranks.virtual_world``: torch's fake process group, whose
collectives move nothing), over the production mesh (``launch.mesh``).
The kernels take their meta route (``kernels.meta``) and
``analysis.cost.counting`` counts the step (``analysis/cost.py``).
Nothing is allocated on any device.

* **AF2 cells** (``--af2``): the paper's BP x DAP x DP plan over the mesh
  (``ParallelPlan.for_mesh``), the kernels K1-K5 on, AdamW (1e-3, clip
  0.1), params and moments replicated, a global batch of 128 over the data
  replicas, one recycle; the step body (``train.trainstep.make_step_body``)
  traced for rank 0 and, under BP, for the first rank of the other branch
  (``roles``: the peak is the larger of the two, the global totals their
  mean).  Also the probes of 1 + 1, 2 + 1 and 1 + 2 blocks (main +
  extra-MSA), whose linear extrapolation checks the full trace (the port
  runs eagerly, so the full trace already counts every block).
* **LM cells** (``--arch``/``--all``): **sized** from the shapes and the
  sanitized partition specs alone (argument, output and alias bytes: the
  train state with ``adafactor_like(1e-4, clip_norm=1.0)`` and the batch,
  or the params, a cache of ``seq_len + 1`` and the tokens), and
  **traced**: rank 0's tensor-parallel step over the production mesh
  (``parallel.tensor`` over 'model' 16; the batch over ('pod', 'data')),
  its slices cut as the model is drawn on ``meta``.
* **Roofline**: ``analysis.roofline.roofline_terms`` with ``HW`` (H100 SXM,
  700 W datasheet); every collective is priced at ``HW.link_bw``, an
  assumption (the 'model' axis of 16 spans two NVLink domains, and
  InfiniBand between nodes is slower); ``collectives_by_axis`` keeps the
  split so the axes can be priced apart.

Usage (records under ``experiments/dryrun_torch/``, or ``REPRO_DRYRUN_OUT``):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --af2 initial --bp 2 --dap 8
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import time
import traceback

import torch

from repro_torch import configs as cfglib
from repro_torch.analysis import cost as acost
from repro_torch.analysis.roofline import (af2_model_flops, model_flops,
                                           roofline_terms)
from repro_torch.launch.mesh import shape_from_env
from repro_torch.models import get_model
from repro_torch.nn.partition import P, make_param_specs
from repro_torch.parallel.mesh_utils import make_mesh
from repro_torch.parallel.ranks import virtual_world
from repro_torch.serve.steps import (cache_partition_rules,
                                     cache_partition_rules_2d, decode_split)
from repro_torch.train.optim import OptState, adafactor_like, adamw
from repro_torch.train.trainstep import (lm_stacked, param_dict,
                                         sanitize_spec, state_shardings)

OUT_DIR = pathlib.Path(os.environ.get(
    "REPRO_DRYRUN_OUT",
    pathlib.Path(__file__).resolve().parents[3] / "experiments"
    / "dryrun_torch"))
META = torch.device("meta")
# the step's scalar outputs: AF2's metrics (train.trainstep.METRICS), the
# LM step's loss and gradient norm, all 0-d fp32
AF2_METRIC_BYTES = 7 * 4
LM_METRIC_BYTES = 2 * 4
LINK_ASSUMPTION = ("every collective priced at HW.link_bw (NVLink 4, 450 "
                   "GB/s a direction); an axis that spans nodes runs over "
                   "InfiniBand, slower")


def _mesh_kind(multi_pod: bool) -> str:
    return "multi_pod" if multi_pod else "single_pod"


# ---------------------------------------------------------------------------
# bytes of this rank's slices
# ---------------------------------------------------------------------------

def local_bytes(shape, itemsize: int, spec, extents: dict) -> int:
    """Bytes of one rank's slice of a leaf of ``shape`` laid out by
    ``spec``, sanitized over ``extents`` (an axis that does not divide a
    dim is dropped, as XLA's argument sizes do)."""
    n = math.prod(shape) * itemsize
    for entry in sanitize_spec(spec, tuple(shape), extents):
        for axis in (entry if isinstance(entry, tuple) else
                     (entry,) if entry is not None else ()):
            n //= extents[axis]
    return n


def tree_bytes(tensors: dict, specs: dict, extents: dict) -> int:
    """Sum of :func:`local_bytes` over {key: tensor or (vr, vc) tuple}."""
    total = 0
    for k, leaf in tensors.items():
        parts = leaf if isinstance(leaf, tuple) else (leaf,)
        sps = specs[k] if isinstance(leaf, tuple) else (specs[k],)
        total += sum(local_bytes(t.shape, t.element_size(), sp, extents)
                     for t, sp in zip(parts, sps))
    return total


def batch_shapes(cfg, shape, *, for_prefill: bool = False) -> dict:
    """{name: (shape, dtype)} of the training / prefill request batch."""
    b, s = shape.global_batch, shape.seq_len
    front, text_len = {}, s
    if cfg.family in ("audio", "vlm"):
        name = "frames" if cfg.family == "audio" else "patches"
        front[name] = ((b, cfg.n_frontend_tokens, cfg.frontend_dim),
                       torch.bfloat16)
        if cfg.family == "vlm":
            text_len = s - cfg.n_frontend_tokens  # backbone seq == assigned
    out = {"tokens": ((b, text_len), torch.int32), **front}
    if not for_prefill:
        out["labels"] = ((b, text_len), torch.int32)
    return out


def _meta(shapes: dict) -> dict:
    return {k: torch.empty(s, dtype=dt, device=META)
            for k, (s, dt) in shapes.items()}


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def size_lm_cell(cfg, shape, extents: dict) -> dict:
    """The memory block of an LM cell from shapes and sanitized specs alone:
    ``argument_bytes``, ``output_bytes``, ``alias_bytes`` and their parts,
    for one rank of a mesh of ``extents`` (the reference's
    ``build_lm_step`` shardings).  Allocates nothing (``meta``)."""
    lm = get_model(cfg)
    params = param_dict(lm.init_params(cfg, device=META))
    data_axes = tuple(a for a in ("pod", "data") if a in extents)
    if shape.kind == "train":
        opt = adafactor_like(1e-4, clip_norm=1.0, stacked=lm_stacked(cfg))
        ost = opt.init(params)
        specs = state_shardings(lm, cfg, extents, params, ost)
        # the optimizer's step: the reference's int32 in its state
        parts = {"params": tree_bytes(params, specs["params"], extents),
                 "opt": 4 + tree_bytes(ost.mu, specs["opt"].mu, extents)
                 + tree_bytes(ost.nu, specs["opt"].nu, extents)}
        batch = _meta(batch_shapes(cfg, shape))
        spec = P(data_axes if len(data_axes) > 1 else data_axes[0])
        parts["batch"] = tree_bytes(batch, {k: spec for k in batch}, extents)
        alias = parts["params"] + parts["opt"]
        return {"argument_bytes": alias + parts["batch"],
                "output_bytes": alias + LM_METRIC_BYTES,
                "alias_bytes": alias, "parts": parts}
    tp_axis, ext = "model", dict(extents)
    split = (decode_split(cfg, extents)
             if shape.kind == "decode" and cfg.factored_decode else None)
    if split is not None:
        ext.pop("model")
        ext.update(split)
        tp_axis, data_axes = ("kvh", "brep"), data_axes + ("brep",)
    pspecs = make_param_specs(params, lm.partition_rules(cfg, tp_axis=tp_axis),
                              stacked=lm_stacked(cfg))
    cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len + 1,
                          device=META)
    crules = (cache_partition_rules_2d(cfg, data_axes=data_axes)
              if split is not None else cache_partition_rules(cfg))
    parts = {"params": tree_bytes(params, pspecs, ext),
             "cache": tree_bytes(cache, make_param_specs(cache, crules), ext)}
    data = data_axes if len(data_axes) > 1 else data_axes[0]
    if shape.kind == "prefill":
        inputs = _meta(batch_shapes(cfg, shape, for_prefill=True))
        if cfg.family not in ("audio", "vlm"):
            inputs = {"tokens": inputs["tokens"]}
    else:
        inputs = {"tokens": torch.empty((shape.global_batch, 1),
                                        dtype=torch.int32, device=META)}
    parts["inputs"] = tree_bytes(
        inputs, {k: P(data, *([None] * (v.dim() - 1)))
                 for k, v in inputs.items()}, ext)
    # the last token's logits (B, 1, vocab) in the compute dtype, this
    # rank's rows (the port splits no vocab)
    logits = local_bytes((shape.global_batch, 1, cfg.vocab), 2,
                         P(data, None, None), ext)
    return {"argument_bytes": sum(parts.values()),
            "output_bytes": parts["cache"] + logits,
            "alias_bytes": parts["cache"], "parts": parts}


def trace_lm_step(cfg, shape, extents: dict, n_devices: int, *,
                  optimizer=None) -> dict:
    """Trace one rank's LM step on a mesh of ``extents``: the training step
    (``make_lm_train_step``: tensor-parallel over 'model', data-parallel
    over ('pod', 'data'), FSDP over 'data' where ``cfg.fsdp``;
    ``optimizer`` by default ``adafactor_like(1e-4, clip_norm=1.0)``; the
    batch is the global batch, which every rank holds and takes its rows
    of), or the prefill / decode step on this rank's rows of the batch and
    its cache (``serve.steps.init_local_cache``), the weights in bf16 as
    ``DecodeEngine`` holds them, its slices by ``serve.steps.serve_layout``
    (under ``factored_decode`` a decode step on the factored mesh,
    gathering the weights over 'brep' inside the step, as the engine
    does).  Each rank's slices are cut as the model is drawn.  Must run
    inside a virtual world of ``n_devices`` ranks."""
    from repro_torch.parallel import tensor
    from repro_torch.parallel.mesh_utils import Axis, mesh_shape
    from repro_torch.serve import steps
    from repro_torch.train import trainstep as ts
    lm = get_model(cfg)
    mesh = make_mesh(tuple(extents.values()), tuple(extents))
    data_axes = tuple(a for a in ("pod", "data") if a in extents)
    if shape.kind == "train":
        opt = optimizer or adafactor_like(1e-4, clip_norm=1.0,
                                          stacked=lm_stacked(cfg))
        batch = _meta(batch_shapes(cfg, shape))
        if math.prod(extents.values()) > 1:
            layout = ts.lm_layout(lm, cfg, ts.lm_shapes(lm, cfg), mesh,
                                  data_axes=data_axes)
            model = lm.init_params(cfg, device=META, cut=layout.cut)
            state = ts.init_lm_state(model, opt, layout=layout)
            step = ts.make_lm_train_step(lm, cfg, opt, mesh,
                                         data_axes=data_axes)
        else:       # one device: the step without a mesh
            state = ts.init_lm_state(lm.init_params(cfg, device=META), opt)
            step = ts.make_lm_train_step(lm, cfg, opt)
        held = _state_tensors(state)
        with acost.counting(held + list(batch.values())) as tr:
            step(state, batch)
        full = tr.analysis(n_devices)
        alias = sum(t.untyped_storage().nbytes() for t in held)
        full["memory"].update(alias_bytes=alias,
                              output_bytes=alias + LM_METRIC_BYTES)
        return full
    layout = steps.serve_layout(lm, cfg, mesh)
    params = lm.BF16.cast(lm.init_params(cfg, device=META, cut=layout.cut))
    factored = bool(shape.kind == "decode" and cfg.factored_decode
                    and decode_split(cfg, extents))
    dmesh = steps.decode_mesh_plan(cfg, mesh)[0] if factored else mesh
    axis = Axis(dmesh, "kvh" if factored else "model")
    cache = steps.init_local_cache(lm, cfg, shape.global_batch,
                                   shape.seq_len + 1, mesh_shape(dmesh),
                                   layout, factored=factored, device=META)
    rows = cache["length"].shape[0]
    local = dataclasses.replace(shape, global_batch=rows)
    if shape.kind == "prefill":
        batch = _meta(batch_shapes(cfg, local, for_prefill=True))
        inputs = batch if cfg.family in ("audio", "vlm") else batch["tokens"]
        fn = lm.prefill
    else:
        inputs = torch.empty((rows, 1), dtype=torch.int32, device=META)
        fn = lm.decode_step
    args = (list(param_dict(params).values()) + list(cache.values())
            + acost._tensors(inputs, []))
    kvh = steps.kvh_shapes(lm, cfg, dmesh) if factored else None
    with acost.counting(args) as tr, tensor.model_parallel(axis):
        if factored:
            params = steps.factored_params(params, layout, kvh,
                                           Axis(dmesh, "brep"), axis)
        logits, _ = fn(params, cfg, inputs, cache)
    full = tr.analysis(n_devices)
    alias = sum(t.untyped_storage().nbytes() for t in cache.values())
    full["memory"].update(alias_bytes=alias,
                          output_bytes=alias + acost._nbytes(logits))
    return full


def _state_tensors(state: dict) -> list:
    """The train state's tensors: parameters and optimizer moments."""
    opt: OptState = state["opt"]
    out = list(param_dict(state["params"]).values())
    for branch in (opt.mu, opt.nu):
        for v in branch.values():
            out += list(v) if isinstance(v, tuple) else [v]
    return out


def run_lm_cell(arch, shape_name, multi_pod, *, probes=True,
                cfg_override=None) -> dict:
    cfg = cfg_override or cfglib.get_config(arch)
    shape = cfglib.SHAPES[shape_name]
    dims, names = shape_from_env(multi_pod)
    extents = dict(zip(names, dims))
    n_dev = math.prod(dims)
    rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_kind(multi_pod),
           "devices": n_dev, "mesh_axes": extents}
    t0 = time.time()
    sized = size_lm_cell(cfg, shape, extents)
    rec["sized"] = sized
    with virtual_world(n_dev):
        rec["full"] = trace_lm_step(cfg, shape, extents, n_dev)
        rec["lower_s"] = round(time.time() - t0, 2)
        rec["status"] = "ok"
        if probes:
            rec["probe"] = probe_per_layer(cfg, shape, extents, n_dev)
            rec["roofline"] = derive_roofline(cfg, shape, rec, n_dev)
    return rec


def probe_per_layer(cfg, shape, extents, n_devices, l1=2, l2=4) -> dict:
    """Reduced-depth traces -> per-layer cost extrapolation (the
    reference's probe; here a check, since an eager trace counts every
    layer)."""
    if cfg.family == "hybrid":
        l1, l2 = cfg.shared_attn_every, 2 * cfg.shared_attn_every
    out = {}
    for name, nl in (("l1", l1), ("l2", l2)):
        over = {"n_layer": nl}
        if cfg.family == "audio":
            over["n_enc_layer"] = nl
        out[name] = trace_lm_step(dataclasses.replace(cfg, **over), shape,
                                  extents, n_devices)
        out[name]["n_layer"] = nl
    return _extrapolate(out, l1, l2, cfg.n_layer)


def _extrapolate(out: dict, n1: int, n2: int, n_full: int) -> dict:
    keys = ("per_device_flops", "per_device_bytes", "collective_bytes_static")
    per = {k: (out["l2"][k] - out["l1"][k]) / (n2 - n1) for k in keys}
    out["extrapolated"] = {k: out["l1"][k] + per[k] * (n_full - n1)
                           for k in keys}
    out["per_layer"] = per
    return out


def _roofline(ex: dict, n_dev: int, useful: float) -> dict:
    total = ex["per_device_flops"] * n_dev
    terms = roofline_terms(total_flops=total,
                           total_bytes=ex["per_device_bytes"] * n_dev,
                           total_collective_bytes=ex["collective_bytes_static"]
                           * n_dev, chips=n_dev)
    terms["model_flops"] = useful
    terms["hlo_flops_global"] = total
    terms["useful_flops_ratio"] = useful / total if total else 0.0
    terms["collective_pricing"] = LINK_ASSUMPTION
    return terms


def derive_roofline(cfg, shape, rec, n_dev) -> dict:
    return _roofline(rec["probe"]["extrapolated"], n_dev,
                     model_flops(cfg, shape.kind, shape.seq_len,
                                 shape.global_batch))


# ---------------------------------------------------------------------------
# AF2 cells (paper model, BP x DAP x DP logical mesh)
# ---------------------------------------------------------------------------

def af2_state(cfg, opt):
    """(model, state, the state's tensors, their bytes) on ``meta``; the
    bytes count the optimizer's step as the 4 bytes of the 0-d tensor the
    step body reads it from."""
    from repro_torch.core.model import AlphaFold2
    from repro_torch.train.trainstep import init_state
    model = AlphaFold2(cfg, device=META)
    state = init_state(model, opt)
    held = _state_tensors(state)
    return state, held, sum(acost._nbytes(t) for t in held) + 4


def af2_batch(cfg, n: int) -> dict:
    """This replica's ``n`` proteins on ``meta`` (``protein_sample_spec``)."""
    from repro_torch.data.protein import protein_sample_spec
    return {k: torch.empty((n,) + shape, dtype=getattr(torch, dt.name),
                           device=META)
            for k, (shape, dt) in protein_sample_spec(cfg).items()}


def trace_af2_step(cfg, built, n_local: int, n_recycle: int,
                   n_devices: int, *, deterministic: bool = True) -> dict:
    """Count one rank's AF2 step body (``make_step_body``) under ``built``
    over ``n_local`` proteins: AdamW (1e-3, clip 0.1), params and moments
    replicated.  Arguments: the state, the batch and the step count (the
    dropout key too when the step draws dropout; an argument the step does
    not read is not counted, as XLA prunes it)."""
    from repro_torch.train.trainstep import make_step_body
    opt = adamw(1e-3, clip_norm=0.1)
    state, held, state_bytes = af2_state(cfg, opt)
    batch = af2_batch(cfg, n_local)
    key = torch.empty((2,), dtype=torch.int64, device=META)
    step = torch.empty((), dtype=torch.float32, device=META)
    body = make_step_body(cfg, opt, built, deterministic=deterministic)
    args = held + list(batch.values()) + [step]
    if not deterministic:
        args.append(key)
    with acost.counting(args) as tr:
        body(state, batch, key, step, n_recycle)
    full = tr.analysis(n_devices)
    full["memory"].update(alias_bytes=state_bytes,
                          output_bytes=state_bytes + AF2_METRIC_BYTES)
    full["memory"]["batch_bytes"] = sum(acost._nbytes(t)
                                        for t in batch.values())
    return full


def _role_ranks(built) -> dict:
    """{role: global rank} of the ranks whose steps differ: the first rank
    of each branch (DAP and data ranks run alike)."""
    from repro_torch.parallel.mesh_utils import axis_size
    ranks = built.mesh.mesh if built.mesh is not None else None
    n_branch = axis_size(built.mesh, "branch")
    if ranks is None or n_branch == 1:
        return {"rank0": 0}
    names = list(built.mesh.mesh_dim_names)
    idx = [0] * len(names)
    out = {}
    for b in range(n_branch):
        idx[names.index("branch")] = b
        out[f"branch{b}"] = int(ranks[tuple(idx)])
    return out


def _af2_plan(cfg, base, *, bp, dap, variant, remat):
    from repro_torch.core.config import with_kernels
    from repro_torch.parallel.plan import ParallelPlan
    plan = ParallelPlan.for_mesh(base, branch=bp, dap=max(dap, 1),
                                 variant=variant, remat=remat)
    cfg = plan.apply_to(with_kernels(cfg))
    return cfg, plan.build(base, cfg=cfg, device=META)


def run_af2_cell(process: str, multi_pod: bool, *, bp=2, dap=8,
                 global_batch=128, variant="parallel", n_recycle=1,
                 remat="block", probes=True, mesh=None) -> dict:
    """One AF2 cell's record.  ``process``: a ``core.config.PRESETS`` name;
    ``mesh``: (extents, axis names) in place of the production mesh (or
    ``REPRO_DRYRUN_MESH``)."""
    from repro_torch.core.config import PRESETS
    base_cfg = PRESETS[process]()
    dims, names = mesh or shape_from_env(multi_pod)
    n_dev = math.prod(dims)
    rec = {"arch": f"af2-{process}", "shape": f"bp{bp}_dap{dap}_b{global_batch}",
           "variant": variant, "mesh": _mesh_kind(multi_pod),
           "devices": n_dev, "mesh_axes": dict(zip(names, dims)),
           "remat": remat, "kernels": "K1-K5 (evo_pallas, pallas)"}
    t0 = time.time()
    with virtual_world(n_dev):
        base = make_mesh(dims, names)
        cfg, built = _af2_plan(base_cfg, base, bp=bp, dap=dap,
                               variant=variant, remat=remat)
        roles = _role_ranks(built)
        dp = built.dp_size
    if global_batch % dp:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"over {dp} data replicas")
    n_local = global_batch // dp
    rec["proteins_per_replica"] = n_local
    traced, probe_out = {}, {}
    for role, rank in roles.items():
        with virtual_world(n_dev, rank=rank):
            base = make_mesh(dims, names)
            cfg, built = _af2_plan(base_cfg, base, bp=bp, dap=dap,
                                   variant=variant, remat=remat)
            traced[role] = trace_af2_step(cfg, built, n_local, n_recycle,
                                          n_dev)
            if probes:
                for name, (nb, ne) in AF2_PROBES.items():
                    c2 = dataclasses.replace(cfg, n_evoformer=nb,
                                             n_extra_msa_blocks=ne)
                    probe_out.setdefault(role, {})[name] = trace_af2_step(
                        c2, built, n_local, n_recycle, n_dev)
    rec["lower_s"] = round(time.time() - t0, 2)
    first = next(iter(traced))
    rec["full"] = traced[first]
    rec["roles"] = {role: _role_summary(traced[role], rank)
                    for role, rank in roles.items()}
    rec["status"] = "ok"
    if probes:
        ex = {r: _extrapolate_af2(probe_out[r], cfg) for r in roles}
        rec["probe"] = probe_out[first]
        mean = {k: sum(e[k] for e in ex.values()) / len(ex)
                for k in ex[first]}
        rec["roofline"] = _roofline(
            mean, n_dev, 3.0 * af2_model_flops(cfg) * global_batch)
        rec["roofline"]["per_device_terms"] = "mean over roles"
    return rec


# (main Evoformer blocks, extra-MSA blocks) of each probe: l1 and l2 are the
# reference's; l2_extra prices an extra-MSA block apart (its MSA is wider
# and its column attention global, so it costs other than a main block)
AF2_PROBES = {"l1": (1, 1), "l2": (2, 1), "l2_extra": (1, 2)}


def _extrapolate_af2(probe: dict, cfg) -> dict:
    """``probe["extrapolated"]`` (and ``per_block``) from the three probes:
    l1 plus each stack's per-block cost times its remaining blocks."""
    keys = ("per_device_flops", "per_device_bytes", "collective_bytes_static")
    per = {stack: {k: probe[name][k] - probe["l1"][k] for k in keys}
           for stack, name in (("evoformer", "l2"), ("extra_msa", "l2_extra"))}
    probe["per_block"] = per
    probe["extrapolated"] = {
        k: probe["l1"][k] + per["evoformer"][k] * (cfg.n_evoformer - 1)
        + per["extra_msa"][k] * (cfg.n_extra_msa_blocks - 1) for k in keys}
    return probe["extrapolated"]


def _role_summary(full: dict, rank: int) -> dict:
    return {"rank": rank, "per_device_flops": full["per_device_flops"],
            "per_device_bytes": full["per_device_bytes"],
            "collective_bytes_static": full["collective_bytes_static"],
            "peak_bytes_estimate": full["memory"]["peak_bytes_estimate"],
            "kernel_nodes": full["kernel_nodes"]}


# ---------------------------------------------------------------------------
# records and the command line
# ---------------------------------------------------------------------------

def cell_path(arch, shape, mesh_kind, suffix=""):
    safe = arch.replace("/", "_").replace(".", "_")
    return OUT_DIR / f"{safe}__{shape}__{mesh_kind}{suffix}.json"


def _save(path: pathlib.Path, rec: dict) -> None:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1, default=str))


def _error(rec: dict, e: Exception) -> dict:
    return {**rec, "status": "error", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:]}


def run_and_save(arch, shape_name, multi_pod, *, probes=True, force=False,
                 suffix="", cfg_override=None):
    mesh_kind = _mesh_kind(multi_pod)
    path = cell_path(arch, shape_name, mesh_kind, suffix)
    if path.exists() and not force:
        print(f"[skip cached] {path.name}")
        return json.loads(path.read_text())
    print(f"[run] {arch} x {shape_name} x {mesh_kind}", flush=True)
    try:
        rec = run_lm_cell(arch, shape_name, multi_pod, probes=probes,
                          cfg_override=cfg_override)
    except Exception as e:  # noqa: BLE001 - record failures, keep sweeping
        rec = _error({"arch": arch, "shape": shape_name, "mesh": mesh_kind},
                     e)
    _save(path, rec)
    status = rec.get("status")
    print(f"[{status}] {path.name}"
          + (f" :: {rec.get('error')}" if status == "error" else ""),
          flush=True)
    return rec


OPT_OVERRIDES = {
    # named optimization sets applied over the baseline cfg
    "moe_sorted": {"moe_dispatch": "sorted"},
    "uniform_decode": {"uniform_decode": True},
    "factored_decode": {"factored_decode": True, "uniform_decode": True},
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", action="append", default=[],
                    choices=list(OPT_OVERRIDES),
                    help="apply named optimization(s), suffix output files")
    ap.add_argument("--af2", choices=["initial", "finetune"])
    ap.add_argument("--bp", type=int, default=2)
    ap.add_argument("--dap", type=int, default=8)
    ap.add_argument("--variant", default="parallel")
    ap.add_argument("--af2-remat", default="block",
                    choices=["block", "none", "dots"])
    ap.add_argument("--ln-bf16", action="store_true",
                    help="LayerNorm output in the compute dtype (bf16 io)")
    args = ap.parse_args(argv)

    if args.ln_bf16:
        from repro_torch.nn import layers as _nl
        _nl.set_ln_fp32_io(False)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    if args.af2:
        for mp in meshes:
            mesh_kind = _mesh_kind(mp)
            rsuf = "" if args.af2_remat == "block" else f"_remat-{args.af2_remat}"
            rsuf += "_lnbf16" if args.ln_bf16 else ""
            path = cell_path(f"af2-{args.af2}", f"bp{args.bp}_dap{args.dap}",
                             mesh_kind, f"_{args.variant}{rsuf}")
            if path.exists() and not args.force:
                print(f"[skip cached] {path.name}")
                continue
            print(f"[run] af2-{args.af2} bp{args.bp} dap{args.dap} "
                  f"{mesh_kind}{rsuf}", flush=True)
            try:
                rec = run_af2_cell(args.af2, mp, bp=args.bp, dap=args.dap,
                                   variant=args.variant,
                                   remat=args.af2_remat,
                                   probes=not args.no_probes)
                if args.ln_bf16:
                    rec["ln_fp32_io"] = False
            except Exception as e:  # noqa: BLE001
                rec = _error({"arch": f"af2-{args.af2}"}, e)
            _save(path, rec)
            print(f"[{rec.get('status')}] {path.name} ({rec.get('lower_s')} s)",
                  flush=True)
        return

    if args.all:
        for arch in cfglib.ARCH_IDS:
            for shape in cfglib.arch_shapes(arch):
                for mp in meshes:
                    run_and_save(arch, shape, mp, probes=not args.no_probes,
                                 force=args.force)
        return

    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, --all, or --af2")
    cfg_override, suffix = None, ""
    if args.opt:
        over = {}
        for name in args.opt:
            over.update(OPT_OVERRIDES[name])
        cfg_override = dataclasses.replace(cfglib.get_config(args.arch), **over)
        suffix = "_opt_" + "-".join(sorted(args.opt))
    for mp in meshes:
        run_and_save(args.arch, args.shape, mp, probes=not args.no_probes,
                     force=args.force, suffix=suffix, cfg_override=cfg_override)


if __name__ == "__main__":
    main()
