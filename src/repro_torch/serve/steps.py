"""Serving steps: prefill and single-token decode, and the sharding rules of
their caches and request batches (counterpart of ``repro/serve/steps.py``).

The steps run on one device.  The rules say how a cache and a batch are laid
out over a ("data", "model") mesh: batch over 'data'; KV heads over 'model'
where divisible, else replicated over it; SSM state heads over 'model'.  The
dry run (``launch/dryrun.py``) sizes each rank's cache by them; serving over
such a mesh needs tensor parallelism over 'model', which the port does not
run yet.
"""
from __future__ import annotations

import math

from repro_torch.models.lmconfig import LMConfig
from repro_torch.nn.partition import P


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


def serve_batch_specs(cfg: LMConfig, *, data_axis="data"):
    """Sharding specs for the request batch (tokens / frames / patches)."""
    return {
        "tokens": P(data_axis, None),
        "frames": P(data_axis, None, None),
        "patches": P(data_axis, None, None),
    }
