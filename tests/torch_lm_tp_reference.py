"""The JAX package's own GSPMD programs for ``tests/test_torch_lm_tp.py``:
run as a script in a fresh interpreter with four fake XLA host devices,

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_lm_tp_reference.py IN.pkl OUT.pkl

``IN.pkl`` holds {"cases": {name: case}, "params": {key: param tree}}; a
case names its smoke config (``arch``, ``overrides``), its ``mesh``
(data, model), its ``params`` key, a training ``batch`` and a serving
``prompt`` batch (numpy).  For each case this runs, under an fp32 policy,
the reference's ``make_lm_train_step`` (one SGD step, the gradient clipped
at global norm ``clip``) and its ``prefill`` then ``decode`` greedy decode
steps, on a mesh built by hand: ``jax.sharding.Mesh`` over the devices,
whose axes are Auto.  ``jax.make_mesh`` would make Explicit axes on JAX
0.9, which ``with_sharding_constraint`` rejects.  Parameters and caches are
placed by the reference's partition and cache rules, sanitized
(``sanitize_spec_tree``); under ``factored_decode`` the decode steps run
on ``decode_mesh_plan``'s mesh with its rules.  ``OUT.pkl``: {name:
{"loss", "grad_norm", "params" (flat, the reference's layout), "logits"
(B, 1 + decode, V), "tokens" (B, decode)}}."""
import dataclasses
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.configs import get_smoke_config
from repro.models import get_model
from repro.nn import layers as jax_layers
from repro.nn.partition import make_param_specs
from repro.serve.steps import (cache_partition_rules,
                               cache_partition_rules_2d, decode_mesh_plan)
from repro.train import optim
from repro.train.trainstep import make_lm_train_step, sanitize_spec_tree

FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def cfg_of(case):
    return dataclasses.replace(
        get_smoke_config(case["arch"], scan_layers=True),
        **case.get("overrides", {}))


def mesh_of(shape):
    n = shape[0] * shape[1]
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))


def compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)


def place(tree, rules, mesh):
    shapes = jax.eval_shape(lambda: tree)
    specs = sanitize_spec_tree(shapes, make_param_specs(shapes, rules), mesh)
    return jax.device_put(tree, jax.tree_util.tree_map(
        lambda sp: NamedSharding(mesh, sp), specs,
        is_leaf=lambda x: isinstance(x, P)))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def recording(opt):
    """``opt`` whose state's ``nu`` carries the gradient's global norm
    after an update (the reference's step returns only the loss)."""
    def update(grads, state, params):
        new_params, new_state = opt.update(grads, state, params)
        return new_params, new_state._replace(nu=optim.global_norm(grads))
    return dataclasses.replace(opt, update=update)


def train(model, cfg, params, batch, mesh, lr, clip):
    opt = recording(optim.sgd(lr, momentum=0.9, clip_norm=clip))
    step, shardings, batch_sharding = make_lm_train_step(model, cfg, opt,
                                                         mesh)
    ost = opt.init(params)
    state = jax.device_put({"params": params, "opt": ost}, shardings(
        jax.eval_shape(lambda: params), jax.eval_shape(lambda: ost)))
    batch = jax.device_put(batch, batch_sharding)
    new, metrics = compiled(step, state, batch)(state, batch)
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(new["opt"].nu),
            "params": flat(new["params"])}


def serve(model, cfg, params, prompt, mesh, max_len, n_decode):
    """Prefill of the prompt batch, then ``n_decode`` greedy decode steps
    (in one program, the steps a ``lax.scan``, where the decode mesh is
    the prefill's): the logits of every step and the tokens fed."""
    p = place(params, model.partition_rules(cfg), mesh)
    b = prompt["tokens"].shape[0]
    cache = place(model.init_cache(cfg, b, max_len, jnp.float32),
                  cache_partition_rules(cfg), mesh)
    arg = prompt if cfg.family in ("audio", "vlm") else prompt["tokens"]
    greedy = lambda lg: jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)

    def decode(p, logits, cache):
        def body(carry, _):
            logits, cache = carry
            nt = greedy(logits)
            logits, cache = model.decode_step(p, cfg, nt, cache)
            return (logits, cache), (nt[:, 0], logits[:, 0])
        _, (tokens, steps) = jax.lax.scan(body, (logits, cache), None,
                                          length=n_decode)
        return tokens.T, jnp.swapaxes(steps, 0, 1)

    if not cfg.factored_decode:
        def fill_and_decode(p, a, c):
            logits, c = model.prefill(p, cfg, a, c)
            return (logits,) + decode(p, logits, c)
        logits, tokens, steps = compiled(fill_and_decode, p, arg, cache)(
            p, arg, cache)
    else:
        fill = lambda p, a, c: model.prefill(p, cfg, a, c)
        logits, cache = compiled(fill, p, arg, cache)(p, arg, cache)
        mesh, tp_axis, data_axes = decode_mesh_plan(cfg, mesh)
        p = place(params, model.partition_rules(cfg, tp_axis=tp_axis), mesh)
        cache = place(jax.device_get(cache), cache_partition_rules_2d(
            cfg, data_axes=tuple(data_axes)), mesh)
        logits = jax.device_put(logits, NamedSharding(mesh, P()))
        tokens, steps = compiled(decode, p, logits, cache)(p, logits, cache)
    return {"logits": np.concatenate([np.asarray(logits),
                                      np.asarray(steps)], 1),
            "tokens": np.asarray(tokens)}


def main(src, dst):
    with open(src, "rb") as f:
        inp = pickle.load(f)
    jax_layers.BF16 = jax_layers.F32
    res = {}
    for name, case in inp["cases"].items():
        cfg = cfg_of(case)
        model = get_model(cfg)
        params = jax.tree_util.tree_map(jnp.asarray,
                                        inp["params"][case["params"]])
        mesh = mesh_of(tuple(case["mesh"]))
        out = train(model, cfg, params, case["batch"], mesh, case["lr"],
                    case["clip"])
        out.update(serve(model, cfg, params, case["prompt"], mesh,
                         case["max_len"], case["decode"]))
        res[name] = out
    with open(dst, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    assert "device_count=4" in os.environ.get("XLA_FLAGS", "")
    main(sys.argv[1], sys.argv[2])
