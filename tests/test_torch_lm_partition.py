"""The port's LM partition rules and sharding helpers against the JAX
package: ``nn.partition.make_param_specs`` over every family's
``partition_rules``, and ``train.trainstep.sanitize_spec`` /
``shardings_for`` / ``_opt_branch_shardings``.

Specs: for each of the six families at ``.reduced(fsdp=True)``, with
``scan_layers`` True and False, the port's spec of every ``state_dict``
key equals the reference's ``make_param_specs`` run over
``jax.eval_shape(init_params)``, with the stacked layer axis dropped where
the reference stacks the layers.  ``sanitize_spec`` is held to the
reference's on a duck-typed mesh (``.shape`` a dict: ``jax.make_mesh``
breaks on the installed JAX) over a grid of shapes, extents and specs.
Everything here is exact.
"""
import dataclasses
import itertools
import types

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.nn.partition import make_param_specs as jax_make_param_specs
from repro.train.trainstep import sanitize_spec as jax_sanitize_spec

from repro_torch import bridge
from repro_torch.models import get_model
from repro_torch.models.lmconfig import LMConfig
from repro_torch.nn.partition import P, make_param_specs, tree_paths
from repro_torch.train.optim import OptState
from repro_torch.train.trainstep import (_opt_branch_shardings, lm_stacked,
                                         sanitize_spec, shardings_for,
                                         state_shardings)

ARCHS = ("glm4-9b", "qwen2-moe-a2.7b", "mamba2-2.7b", "zamba2-7b",
         "whisper-medium", "internvl2-26b")


def _ref_specs(cfg) -> dict:
    """The reference's specs by '/'-path, its stacks' leading axis
    dropped (paths without the layer index) where it scans."""
    jm = jax_get_model(cfg)
    shapes = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    specs = jax_make_param_specs(shapes, jm.partition_rules(cfg))
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    out = {}
    for path, spec in flat:
        keys = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        spec = tuple(spec)
        if cfg.scan_layers and keys.split("/")[0] in bridge.LM_STACKED:
            assert spec == () or spec[0] is None, (keys, spec)
            spec = spec[1:]
        out[keys] = spec
    return out


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(arch, scan):
    cfg = jax_smoke_config(arch, fsdp=True, scan_layers=scan)
    want = _ref_specs(cfg)
    pcfg = LMConfig(**dataclasses.asdict(cfg))
    lm = get_model(pcfg)
    named = {k: tuple(p.shape)
             for k, p in lm.init_params(pcfg, device="cpu")
             .named_parameters()}
    got = make_param_specs(named, lm.partition_rules(pcfg),
                           stacked=lm_stacked(pcfg))
    assert any("data" in s for s in got.values())   # FSDP rules armed
    assert len(got) == len(named)
    for key, spec in got.items():
        path = key.replace(".", "/")
        if scan and path.split("/")[0] in bridge.LM_STACKED:
            head, _, rest = path.partition("/")
            path = head + "/" + rest.partition("/")[2]
        assert isinstance(spec, P)
        assert tuple(spec) == want[path], (key, spec, want[path])
    assert sorted(tree_paths(named)) == sorted(k.replace(".", "/")
                                               for k in named)


def test_stacked_rule_that_shards_the_layer_axis_raises():
    rules = [(r"w", P("data", None))]
    with pytest.raises(ValueError, match="stacked layer axis"):
        make_param_specs({"layers.0.w": (4, 4)}, rules, stacked=("layers",))
    with pytest.raises(ValueError, match="rank 3 > param rank 2"):
        make_param_specs({"w": (4, 4)}, [(r"w", P(None, None, "data"))])


SPECS = [(), ("data",), (None, "data"), ("model", "data"),
         (("data", "model"),), (("model", "data"), None), ("data", "model")]
SHAPES = [(1,), (6,), (4, 6), (3, 8), (8, 5, 2)]
EXTENTS = [(1, 1), (2, 1), (2, 3), (4, 2)]


def test_sanitize_spec_equals_the_references():
    """Every spec of rank at most the shape's on every shape and mesh of
    the grid; the port takes the mesh's extents as a mapping."""
    n = 0
    for (d, m), shape, spec in itertools.product(EXTENTS, SHAPES, SPECS):
        if len(spec) > len(shape):
            continue
        ext = {"data": d, "model": m}
        want = jax_sanitize_spec(JP(*spec), shape,
                                 types.SimpleNamespace(shape=ext))
        got = sanitize_spec(P(*spec), shape, ext)
        assert tuple(got) == tuple(want), (ext, shape, spec)
        n += 1
    assert n > 100


def test_shardings_and_optimizer_branch_specs():
    """``shardings_for`` is ``make_param_specs`` then ``sanitize_spec``;
    ``state_shardings`` gives the moments the params' specs, fitted to a
    factored moment's row and column factors and to a scalar."""
    cfg = LMConfig(**dataclasses.asdict(jax_smoke_config("glm4-9b",
                                                          fsdp=True)))
    lm = get_model(cfg)
    named = {k: tuple(p.shape) for k, p in
             lm.init_params(cfg, device="cpu").named_parameters()}
    ext = {"data": 2, "model": 1}
    got = shardings_for(named, lm.partition_rules(cfg), ext)
    assert got["layers.0.wq.w"] == P("data", "model")
    assert got["embed.table"] == P("model", "data")
    assert got["layers.0.ln1.scale"] == P(None)
    odd = shardings_for({"lm_head.w": (127, 128)}, lm.partition_rules(cfg),
                        ext)
    assert odd["lm_head.w"] == P(None, "model")      # 127 rows stay whole
    st = state_shardings(lm, cfg, ext, named)
    assert st["params"] == got and st["opt"].mu == got
    shapes = {"w": (4, 6)}
    pspecs = {"w": P("data", "model")}
    branch = {"w": (types.SimpleNamespace(shape=(4,)),
                    types.SimpleNamespace(shape=(6,)))}
    assert _opt_branch_shardings(shapes, pspecs, branch) == {
        "w": (P("data"), P("model"))}
    assert _opt_branch_shardings(shapes, pspecs, {"w": ()}) == {"w": P()}
    full = state_shardings(lm, cfg, ext, named, OptState(0, named, named))
    assert full["opt"].nu == got
