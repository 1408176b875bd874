"""The port's config dataclasses equal the JAX ones, and ``repro_torch.bridge``
carries an af2_tiny parameter tree into the port and back bit for bit."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import config as jcfg
from repro.core import model as jaf2

from repro_torch import bridge
from repro_torch.core import config as tcfg
from repro_torch.core.model import AlphaFold2
from repro_torch.nn.layers import Policy, count_params



def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else f.default_factory) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["EvoformerConfig", "StructureConfig",
                                  "AlphaFold2Config"])
def test_config_fields_and_defaults_equal(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    jf, tf = _fields(j), _fields(t)
    assert [n for n, _ in jf] == [n for n, _ in tf]
    assert dataclasses.asdict(j()) == dataclasses.asdict(t())


@pytest.mark.parametrize("preset", ["af2_tiny", "af2_small", "af2_initial",
                                    "af2_finetune"])
def test_config_presets_equal(preset):
    for variant in ("parallel", "af2"):
        j = getattr(jcfg, preset)(variant=variant)
        t = getattr(tcfg, preset)(variant=variant)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_with_kernels_selects_kernel_impls():
    cfg = tcfg.with_kernels(tcfg.af2_initial())
    for ev in (cfg.evoformer, cfg.extra):
        assert (ev.attention_impl, ev.tri_mult_impl) == ("evo_pallas", "pallas")
    assert cfg.extra.global_column_attn and cfg.n_evoformer == 48


def test_bridge_round_trips_af2_tiny_bit_for_bit():
    """The reference's af2_tiny tree (its structure, shapes and dtypes from
    ``jax.eval_shape``; numpy values, as compiling its init takes ~11 s)
    goes into the port and back unchanged."""
    cfg = jcfg.af2_tiny()
    rng = np.random.default_rng(3)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype),
        jax.eval_shape(lambda k: jaf2.init_params(k, cfg),
                       jax.random.PRNGKey(3)))
    model = bridge.load_jax_params(
        AlphaFold2(tcfg.af2_tiny(), device="cpu"), tree)
    assert count_params(model) == sum(x.size for x in
                                      jax.tree_util.tree_leaves(tree))
    sd = model.state_dict()
    assert "evoformer.1.row_attn.q.w" in sd                  # split block axis
    assert sd["evoformer.1.row_attn.q.w"].shape == (cfg.c_m, 16)  # (in, out)
    back = bridge.state_dict_to_params(sd)
    flat_a, flat_b = bridge.flatten(tree), bridge.flatten(back)
    assert sorted(flat_a) == sorted(flat_b)
    for k in flat_a:
        assert flat_a[k].dtype == flat_b[k].dtype, k
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=k)


def test_port_init_matches_reference_init_rules():
    """Same shapes as the JAX init, zero-init final layers, gate biases one,
    lecun truncated-normal dense weights; a seed fixes the weights."""
    cfg = tcfg.af2_tiny()
    model = AlphaFold2(cfg, seed=5, device="cpu")
    shapes = jax.eval_shape(lambda k: jaf2.init_params(k, jcfg.af2_tiny()),
                            jax.random.PRNGKey(0))
    want = {k: v.shape for k, v in bridge.flatten(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                               shapes)).items()}
    got = {k: tuple(v.shape) for k, v in bridge.flatten(
        bridge.state_dict_to_params(model.state_dict())).items()}
    assert got == want
    blk = model.evoformer[0]
    assert torch.all(blk.row_attn.out.w == 0) and torch.all(blk.row_attn.gate.b == 1)
    assert torch.all(blk.tri_mul_out.a_gate.b == 1)
    w = blk.msa_trans.w1.w
    assert w.abs().max() <= 2.0 / w.shape[0] ** 0.5 + 1e-6
    assert 0.5 < float(w.detach().std()) * w.shape[0] ** 0.5 < 1.0  # 2σ cut
    again = AlphaFold2(cfg, seed=5, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    bf = Policy().cast(model)
    assert bf is not model and next(bf.parameters()).dtype == torch.bfloat16
    assert next(model.parameters()).dtype == torch.float32
