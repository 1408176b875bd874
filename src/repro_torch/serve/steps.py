"""Serving steps: prefill and single-token decode, and the sharding rules of
their caches and request batches (counterpart of ``repro/serve/steps.py``).

The rules say how a cache and a batch are laid out over a ("data",
"model") mesh: batch over 'data'; KV heads over 'model' where divisible,
else replicated over it; SSM state heads over 'model'.  The dry run
(``launch/dryrun.py``) sizes each rank's cache by them, and a rank of a
tensor-parallel ``serve.engine.DecodeEngine`` holds its cache by them
(:func:`init_local_cache`), its parameters by :func:`serve_layout`.

One deviation: an SSM ``conv`` cache holds this rank's x channels and the
whole B and C (what the rank's convolution reads), where the rule cuts the
concatenated channels evenly (ROADMAP "Reference caveats" lists the
bytes).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.lmconfig import LMConfig
from repro_torch.nn.partition import P, make_param_specs


def make_serve_step(model, cfg: LMConfig):
    """decode: (params, tokens (B, 1), cache) -> (logits, cache)."""
    def serve_step(params, tokens1, cache):
        return model.decode_step(params, cfg, tokens1, cache)
    return serve_step


def make_prefill_step(model, cfg: LMConfig):
    def prefill_step(params, batch, cache):
        return model.prefill(params, cfg, batch, cache)
    return prefill_step


def cache_partition_rules(cfg: LMConfig, *, tp_axis="model", data_axis="data"):
    """Regex rules over cache-tree paths (specs sanitized later).

    KV heads shard over TP when divisible (attention fully local).  For
    narrow GQA (kv_heads < tp) the cache replicates over the model axis:
    sharding head_dim instead would put the QK contraction on the model
    axis and force a per-step logits psum; replication keeps decode
    attention local and the step bound by cache reads."""
    kv_on_heads = cfg.n_kv_head and cfg.n_kv_head % 16 == 0
    kv_spec = (P(None, data_axis, None, tp_axis, None) if kv_on_heads
               else P(None, data_axis, None, None, None))
    return [
        (r"^(k|v|xk|xv|shared_k|shared_v)$", kv_spec),
        (r"^conv$", P(None, data_axis, None, tp_axis)),
        (r"^S$", P(None, data_axis, tp_axis, None, None)),
        (r"^length$", P(data_axis)),
    ]


def decode_split(cfg: LMConfig, extents: dict):
    """The factored decode layout's split of 'model' for narrow GQA, as
    ``[("kvh", f), ("brep", rest)]``, or None where the flat mesh serves
    (no KV heads, no model axis, or KV heads the model axis divides)."""
    tp = extents.get("model", 1)
    kvh = cfg.n_kv_head
    if not kvh or tp == 1 or kvh % tp == 0:
        return None
    f = math.gcd(kvh, tp)
    return [("kvh", f), ("brep", tp // f)]


def decode_mesh_plan(cfg: LMConfig, mesh):
    """2-D factored decode sharding for narrow GQA (the reference's §Perf
    H2 iteration 3): 'model' factors into (kvh, brep), heads shard kvh-way
    and the rest of the model axis goes onto the batch, so attention is
    local and the cache divides by the full rank count.

    ``mesh`` is a ``DeviceMesh`` over (pod?, data, model).  Returns (mesh',
    tp_axis, data_axes): tp_axis may be a tuple (product sharding) for the
    weight rules."""
    from repro_torch.parallel.mesh_utils import mesh_shape, refactor_mesh
    extents = mesh_shape(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in extents)
    split = decode_split(cfg, extents)
    if split is None:
        return mesh, "model", data_axes
    return (refactor_mesh(mesh, {"model": split}), ("kvh", "brep"),
            data_axes + ("brep",))


def cache_partition_rules_2d(cfg: LMConfig, *, data_axes=("data", "brep"),
                             kv_axis="kvh"):
    """Cache rules for the factored decode mesh."""
    batch = data_axes if len(data_axes) > 1 else data_axes[0]
    return [
        (r"^(k|v|xk|xv|shared_k|shared_v)$", P(None, batch, None, kv_axis, None)),
        (r"^conv$", P(None, batch, None, kv_axis)),
        (r"^S$", P(None, batch, kv_axis, None, None)),
        (r"^length$", P(batch)),
    ]


def serve_layout(lm, cfg: LMConfig, mesh):
    """The ``parallel.fsdp.Layout`` a serving rank holds its parameters by:
    each leaf split over ``model`` as its sanitized spec says, whole over
    'data' (serving gathers nothing a step; under ``cfg.fsdp`` the spec's
    data entries are not taken).  Cut a model to it as it is drawn:
    ``lm.init_params(cfg, ..., cut=serve_layout(...).cut)``."""
    from repro_torch.parallel import fsdp
    from repro_torch.parallel.mesh_utils import Axis
    from repro_torch.train import trainstep
    shapes = trainstep.lm_shapes(lm, cfg)
    specs = trainstep.state_shardings(lm, cfg, mesh, shapes)["params"]
    return fsdp.Layout(specs, shapes, Axis(None, "data"),
                       model=Axis(mesh, "model"))


def kvh_shapes(lm, cfg: LMConfig, dmesh) -> dict:
    """{key: shape} of the parameters a factored decode step computes with
    on the mesh ``dmesh`` (``decode_mesh_plan``'s): the weight rules over
    ("kvh", "brep"), sanitized, each dim that keeps 'kvh' split over it
    alone ('brep' gathered)."""
    from repro_torch.parallel.mesh_utils import mesh_shape
    from repro_torch.train import trainstep
    shapes = trainstep.lm_shapes(lm, cfg)
    specs = trainstep.shardings_for(
        shapes, lm.partition_rules(cfg, tp_axis=("kvh", "brep")), dmesh,
        stacked=trainstep.lm_stacked(cfg))
    f = mesh_shape(dmesh)["kvh"]
    out = {}
    for key, shape in shapes.items():
        shape = list(shape)
        for i, entry in enumerate(specs[key]):
            if entry == "kvh" or (isinstance(entry, tuple) and "kvh" in entry):
                shape[i] //= f
        out[key] = tuple(shape)
    return out


def factored_params(params, layout, kvh: dict, brep, kvh_axis):
    """``params`` (a rank's slices by the flat ``layout``) as the factored
    decode step computes with them on ``kvh_axis`` (``kvh``:
    :func:`kvh_shapes`): each leaf the flat layout splits over 'model'
    gathered over ``brep``, as GSPMD gathers it; a leaf held whole cut to
    its 'kvh' slice where the factored spec splits it.  Raises naming a
    leaf whose shape comes out otherwise."""
    import copy
    from repro_torch.parallel import collectives as coll
    memo = {}
    for key, p in params.named_parameters():
        want = kvh[key]
        if layout.mdims[key] is not None:
            t = coll.all_gather(p, brep, layout.mdims[key])
        else:
            t = p
            for i, (have, n) in enumerate(zip(p.shape, want)):
                if have != n:
                    t = t.narrow(i, kvh_axis.index * n, n)
        if tuple(t.shape) != want:
            raise ValueError(f"{key}: {tuple(t.shape)} on the factored "
                             f"decode mesh, not {want}")
        memo[id(p)] = t
    return copy.deepcopy(params, memo)


def cache_specs(lm, cfg: LMConfig, batch: int, max_len: int, extents: dict,
                *, factored: bool = False) -> dict:
    """{key: sanitized spec} of a cache of ``batch`` rows over a mesh of
    ``extents`` (the flat rules, or ``factored``: the 2-D decode rules)."""
    from repro_torch.train.trainstep import sanitize_spec
    shapes = {k: tuple(t.shape) for k, t in
              lm.init_cache(cfg, batch, max_len, device="meta").items()}
    data_axes = tuple(a for a in ("pod", "data", "brep") if a in extents)
    rules = (cache_partition_rules_2d(cfg, data_axes=data_axes) if factored
             else cache_partition_rules(cfg))
    specs = make_param_specs(shapes, rules)
    return {k: sanitize_spec(specs[k], shapes[k], extents) for k in shapes}


def init_local_cache(lm, cfg: LMConfig, batch: int, max_len: int, extents,
                     layout, *, factored: bool = False,
                     dtype=torch.bfloat16, device=None) -> dict:
    """This rank's cache of ``batch`` rows over a mesh of ``extents``: each
    dim its sanitized spec splits divided by the axes' extents, but an SSM
    ``conv`` whose x channels the served ``layout`` splits holds this
    rank's x channels and the whole B and C (the module docstring)."""
    from repro_torch.device import resolve_device
    device = resolve_device(device)
    full = lm.init_cache(cfg, batch, max_len, dtype, device="meta")
    specs = cache_specs(lm, cfg, batch, max_len, extents, factored=factored)
    out = {}
    for key, t in full.items():
        shape = list(t.shape)
        for i, entry in enumerate(specs[key]):
            for name in (entry if isinstance(entry, tuple) else (entry,)):
                if name is not None:
                    shape[i] //= extents[name]
        if key == "conv" and layout is not None:
            di = layout.local_shape("layers.0.wx.w")[-1]
            shape[-1] = di + 2 * cfg.ssm_state
        out[key] = torch.zeros(shape, dtype=t.dtype, device=device)
    return out


def serve_batch_specs(cfg: LMConfig, *, data_axis="data"):
    """Sharding specs for the request batch (tokens / frames / patches)."""
    return {
        "tokens": P(data_axis, None),
        "frames": P(data_axis, None, None),
        "patches": P(data_axis, None, None),
    }
