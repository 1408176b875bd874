"""Rank program of ``tests/test_torch_lm_tp.py``: four gloo ranks on the
CPU, the LM families at their reduced widths under an fp32 policy, the
tensor-parallel train step, prefill and decode over (data, model) meshes.
Imports no JAX.

Each case's weights are the reference's (numpy trees in its layout); a
rank draws its slices of a model (``init_params(cut=layout.cut)``) and
loads its slices of the tree into it (``bridge.rank_state_dict``).  A case
runs on the first data x model ranks of the world; the others skip it.
Rank 0 returns the gathered parameters; every rank returns its local
shapes, the sums of its slices, and its collective counts.
:func:`one_device` runs the one-device step and decode of each weight set,
in the test's own process while the ranks run."""
import dataclasses

import numpy as np
import torch

from repro_torch import bridge, configs
from repro_torch.models import dense, get_model
from repro_torch.models.lmconfig import LMConfig, with_kernels
from repro_torch.nn.layers import Policy
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import tensor
from repro_torch.parallel.mesh_utils import Axis, make_mesh, mesh_shape
from repro_torch.serve import steps
from repro_torch.train import trainstep as ts
from repro_torch.train.optim import sgd

F32 = Policy(compute_dtype=torch.float32)


def case_cfg(case) -> LMConfig:
    cfg = with_kernels(configs.get_smoke_config(case["arch"]))
    return dataclasses.replace(cfg, **case.get("overrides", {}))


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def _sums(named):
    """{key: (sum, sum of squares)} in float64: what a slice holds."""
    out = {}
    for k, t in named:
        a = t.detach().double()
        out[k] = (a.sum().item(), a.square().sum().item())
    return out


def _model(lm, cfg, tree, layout=None):
    """The family's model holding the tree's weights: whole, or this
    rank's slices by ``layout`` (the module built cut, on ``meta``, then
    given storage and loaded leaf by leaf)."""
    cut = None if layout is None else layout.cut
    model = lm.init_params(cfg, device="meta", cut=cut).to_empty(
        device="cpu")
    if layout is None:
        sd = bridge.params_to_state_dict(tree, stacked=bridge.LM_STACKED)
    else:
        sd = bridge.rank_state_dict(tree, layout.local,
                                    stacked=bridge.LM_STACKED)
    model.load_state_dict(sd)
    return model


def _batch(arrays):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}


def train_case(lm, cfg, case, tree, mesh=None, data_axes=("data",)):
    """One SGD step: (loss, grad_norm, counts, the model, the state, the
    layout, the sums of the slices held before the step)."""
    opt = sgd(case["lr"], momentum=0.9, clip_norm=case["clip"])
    layout = None
    if mesh is not None:
        layout = ts.lm_layout(lm, cfg, ts.lm_shapes(lm, cfg), mesh,
                              data_axes=data_axes)
    model = _model(lm, cfg, tree, layout)
    held = _sums(model.named_parameters())
    state = ts.init_lm_state(model, opt, layout=layout)
    step = ts.make_lm_train_step(lm, cfg, opt, mesh, data_axes=data_axes)
    coll.reset_counts()
    state, m = step(state, _batch(case["batch"]))
    return (m["loss"].item(), m["grad_norm"].item(), coll.counts(), model,
            state, layout, held)


@torch.no_grad()
def serve_case(lm, cfg, case, tree, mesh=None):
    """Prefill of this rank's rows of the prompt batch, then greedy decode
    steps: (logits of every step (rows, 1 + decode, V), tokens, counts of
    the prefill and of one decode step).  On a mesh the weights are the
    serving layout's slices, the caches the cache rules' (``serve
    .steps.init_local_cache``), the decode steps on the factored mesh
    under ``factored_decode``."""
    prompt = _batch(case["prompt"])
    b = prompt["tokens"].shape[0]
    layout = None if mesh is None else steps.serve_layout(lm, cfg, mesh)
    params = _model(lm, cfg, tree, layout)
    extents = {"data": 1, "model": 1} if mesh is None else mesh_shape(mesh)
    axis = Axis(mesh, "model")
    rows = slice(0, b)
    if extents["data"] > 1:
        n = b // extents["data"]
        rows = slice(Axis(mesh, "data").index * n,
                     (Axis(mesh, "data").index + 1) * n)
    prompt = {k: v[rows] for k, v in prompt.items()}
    cache = steps.init_local_cache(lm, cfg, rows.stop - rows.start,
                                   case["max_len"], extents, layout,
                                   dtype=torch.float32, device="cpu")
    arg = prompt if cfg.family in ("audio", "vlm") else prompt["tokens"]
    coll.reset_counts()
    with tensor.model_parallel(axis):
        logits, cache = lm.prefill(params, cfg, arg, cache)
        counts = {"prefill": coll.counts()}
        out = [tensor.full_vocab(logits, cfg.vocab)]
        nt = tensor.greedy(logits[:, -1], cfg.vocab)
    dec_axis, batch_axes = axis, [Axis(mesh, "data")]
    if mesh is not None and cfg.factored_decode \
            and steps.decode_split(cfg, extents):
        dmesh, _, _ = steps.decode_mesh_plan(cfg, mesh)
        dec_axis, brep = Axis(dmesh, "kvh"), Axis(dmesh, "brep")
        params = steps.factored_params(params, layout,
                                       steps.kvh_shapes(lm, cfg, dmesh),
                                       brep, dec_axis)
        batch_axes = [Axis(dmesh, "data"), brep]
        n = nt.shape[0] // brep.size
        pick = slice(brep.index * n, (brep.index + 1) * n)
        nt = nt[pick]
        for key, t in cache.items():
            if key == "length":
                cache[key] = t[pick].clone()
                continue
            t = t[:, pick]
            h = t.shape[-2] // dec_axis.size
            cache[key] = t.narrow(-2, dec_axis.index * h, h).clone()
    tokens = []
    for i in range(case["decode"]):
        tokens.append(coll.gather_rows(nt, batch_axes))
        if i == 0:
            coll.reset_counts()
        with tensor.model_parallel(dec_axis):
            logits, cache = lm.decode_step(params, cfg, nt[:, None], cache)
            if i == 0:
                counts["decode"] = coll.counts()
            out.append(coll.gather_rows(tensor.full_vocab(logits, cfg.vocab),
                                        batch_axes[1:]))
            nt = tensor.greedy(logits[:, -1], cfg.vocab)
    return (_np(torch.cat(out, 1)), _np(torch.stack(tokens, 1)), counts)


def conjugate_pair(axis):
    """Gradients through ``reduce_from`` / ``copy_to`` / ``psum`` of
    ``x * (index + 1)`` weighted by ``w``, and the counts of each."""
    out = {}
    for name, fn in (("reduce_from", coll.reduce_from),
                     ("copy_to", coll.copy_to),
                     ("psum", lambda x, a: coll.psum(x, a))):
        x = torch.arange(1.0, 4.0, requires_grad=True)
        w = torch.tensor([1.0, -2.0, 0.5])
        coll.reset_counts()
        y = fn(x * (axis.index + 1), axis)
        (g,) = torch.autograd.grad((y * w).sum(), x)
        out[name] = {"y": _np(y), "grad": _np(g),
                     "psum": coll.counts()["psum"]}
    return out


def engine_tokens(lm, cfg, tree, mesh=None):
    """Greedy tokens of three requests (prompts of 6, 8 and 10 tokens) on
    two slots of a ``DecodeEngine``, whole or on this rank of ``mesh``,
    under an fp32 policy: the engine's bf16 cast and its caches' dtype
    replaced for the call (at bf16 the reduced configs' near-uniform
    logits put ties within rounding)."""
    from repro_torch.serve import engine as eng
    saved = eng.Policy, steps.init_local_cache, lm.init_cache
    init_local, init_cache = steps.init_local_cache, lm.init_cache
    eng.Policy = lambda: F32
    steps.init_local_cache = lambda *a, **k: init_local(
        *a, **dict(k, dtype=torch.float32))
    lm.init_cache = lambda c, b, n, dtype=None, device=None: init_cache(
        c, b, n, torch.float32, device=device)
    try:
        layout = None if mesh is None else steps.serve_layout(lm, cfg, mesh)
        reqs = [eng.Request(i, np.random.default_rng(i).integers(
            0, cfg.vocab, 6 + 2 * i), 5) for i in range(3)]
        e = eng.DecodeEngine(lm, cfg, _model(lm, cfg, tree, layout),
                             batch_slots=2, max_len=24, device="cpu",
                             mesh=mesh)
        return e.run(reqs)
    finally:
        eng.Policy, steps.init_local_cache, lm.init_cache = saved


def refusals(meshes):
    """The messages of layouts the port does not compute."""
    from repro_torch.nn.partition import P
    from repro_torch.parallel import fsdp
    mesh = meshes[(2, 2)]
    out = {}
    try:
        fsdp.Layout({"layers.0.x.w": P(None, ("data", "model"))},
                    {"layers.0.x.w": (4, 8)}, Axis(mesh, "data"),
                    model=Axis(mesh, "model"))
    except ValueError as e:
        out["both_axes"] = str(e)
    with tensor.model_parallel(Axis(mesh, "model")):
        try:
            tensor.split_of(3, 8, "layers.0.mlp.w_gate.w")
        except ValueError as e:
            out["uneven"] = str(e)
    return out


def run(rank, world, device, inp):
    dense.BF16 = F32
    meshes = {tuple(s): make_mesh(s, ("data", "model"),
                                  ranks=range(s[0] * s[1]))
              for s in inp["meshes"]}
    res = {"pair": conjugate_pair(Axis(meshes[(1, 2)], "model"))
           if rank < 2 else None, "cases": {},
           "refusals": refusals(meshes), "engine": {}}
    for name, case in inp["cases"].items():
        shape = tuple(case["mesh"])
        if rank >= shape[0] * shape[1]:
            continue
        cfg = case_cfg(case)
        lm = get_model(cfg)
        lm.BF16 = F32
        tree = inp["params"][case["params"]]
        mesh = meshes[shape]
        loss, norm, counts, model, state, layout, held = train_case(
            lm, cfg, case, tree, mesh)
        out = {"loss": loss, "grad_norm": norm, "counts": counts,
               "local": {k: tuple(p.shape)
                         for k, p in model.named_parameters()},
               "mu_local": {k: tuple(t.shape)
                            for k, t in state["opt"].mu.items()},
               "sums": held,
               "held": layout.bytes_held(dict(model.named_parameters())),
               "mdims": dict(layout.mdims), "dims": dict(layout.dims)}
        full = ts.lm_full_state(state)
        logits, tokens, scounts = serve_case(lm, cfg, case, tree, mesh)
        out.update(logits=logits, tokens=tokens, serve_counts=scounts)
        if rank == 0:
            out["params"] = bridge.flatten(bridge.state_dict_to_params(
                full["params"], stacked=bridge.LM_STACKED))
        res["cases"][name] = out
    # the batch over ('pod', 'data'): FSDP over 'data', 'pod' a replica
    pod = make_mesh((2, 2, 1), ("pod", "data", "model"))
    case = inp["pod"]
    cfg = case_cfg(case)
    lm = get_model(cfg)
    lm.BF16 = F32
    loss, norm, counts, _, state, layout, _ = train_case(
        lm, cfg, case, inp["params"][case["params"]], pod, ("pod", "data"))
    full = ts.lm_full_state(state)
    res["pod"] = {"loss": loss, "grad_norm": norm, "counts": counts,
                  "dims": dict(layout.dims)}
    if rank == 0:
        res["pod"]["params"] = bridge.flatten(bridge.state_dict_to_params(
            full["params"], stacked=bridge.LM_STACKED))
    for name, case in inp["engine"].items():
        shape = tuple(case["mesh"])
        if rank >= shape[0] * shape[1]:
            continue
        cfg = case_cfg(case)
        lm = get_model(cfg)
        lm.BF16 = F32
        tree = inp["params"][case["params"]]
        res["engine"][name] = engine_tokens(lm, cfg, tree, meshes[shape])
    return res


def one_key(case) -> str:
    """The one-device run a case is held to: its weights' (and, under
    ``factored_decode``, a config of its own)."""
    return case["params"] + ("/f" if case.get("overrides", {}).get(
        "factored_decode") else "")


def one_device(inp) -> dict:
    """The one-device step, prefill and decode of each weight set, and the
    one-device engine's tokens of each engine case, under the fp32 policy
    (the families' policies restored after: this runs in the test's own
    process, beside the ranks)."""
    from repro_torch.models import (hybrid, moe, ssm, vlm, whisper)
    mods = (dense, moe, ssm, hybrid, whisper, vlm)
    saved = [m.BF16 for m in mods]
    for m in mods:
        m.BF16 = F32
    try:
        res = {"one": {}, "engine": {}}
        for case in inp["cases"].values():
            key = one_key(case)
            if key in res["one"]:
                continue
            cfg = case_cfg(case)
            lm = get_model(cfg)
            tree = inp["params"][case["params"]]
            loss, norm, _, model, _, _, _ = train_case(lm, cfg, case, tree)
            logits, tokens, _ = serve_case(lm, cfg, case, tree)
            res["one"][key] = {
                "loss": loss, "grad_norm": norm, "logits": logits,
                "tokens": tokens, "params": bridge.flatten(
                    bridge.state_dict_to_params(
                        dict(model.named_parameters()),
                        stacked=bridge.LM_STACKED))}
        for name, case in inp["engine"].items():
            cfg = case_cfg(case)
            res["engine"][name] = engine_tokens(
                get_model(cfg), cfg, inp["params"][case["params"]])
        return res
    finally:
        for m, b in zip(mods, saved):
            m.BF16 = b
