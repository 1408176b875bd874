"""The port's structure module (IPA with a padded-residue mask) against the
JAX module, at af2_tiny widths, fp32.

Tolerance 1e-4 on the frames and the single rep: the reference's own pin
for structure-module outputs (tests/test_structure.py) — eight chained IPA
layers compose rotations, so fp32 rounding compounds.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import structure as jst
from repro.core.config import af2_tiny

from repro_torch import bridge
from repro_torch.core import structure as tst
from repro_torch.core.config import StructureConfig

from torch_util import load_into, max_abs, randomize_np, t

SC = af2_tiny().structure


@pytest.fixture(scope="module")
def params():
    """Randomized structure-module params in the reference's layout, made
    once for both cases: the port's init plus N(0, 0.05) numpy noise
    (``tests/test_torch_bridge.py`` pins the port's init to the
    reference's shapes and rules; compiling the reference's init and noise
    takes ~5 s)."""
    mod = tst.StructureModule(StructureConfig(**SC.__dict__),
                              generator=torch.Generator().manual_seed(0))
    return randomize_np(bridge.state_dict_to_params(mod.state_dict(),
                                                    stacked=()), 2, 0.05)


@pytest.mark.parametrize("masked", [False, True])
def test_structure_module_matches_jax(params, masked):
    r = 12
    rng = np.random.default_rng(4)
    s_init = rng.standard_normal((r, SC.c_s)).astype(np.float32)
    z = rng.standard_normal((r, r, SC.c_z)).astype(np.float32)
    res_mask = np.ones((r,), np.float32)
    if masked:
        res_mask[-3:] = 0.0
    # the reference under one jax.jit, not op by op
    (rots_j, trans_j), (_, traj_j), s_j = jax.jit(
        lambda p, s, zz, m: jst.structure_module(p, SC, s, zz, m))(
        params, s_init, z, res_mask if masked else None)

    cfg = StructureConfig(**SC.__dict__)
    mod = load_into(tst.StructureModule(cfg, generator=torch.Generator()),
                    params, stacked=())
    with torch.no_grad():
        (rots_t, trans_t), (_, traj_t), s_t = tst.structure_module(
            mod, cfg, t(s_init), t(z), t(res_mask) if masked else None)
    assert np.abs(np.asarray(trans_j)).max() > 0.1      # frames really move
    for got, want in ((rots_t, rots_j), (trans_t, trans_j),
                      (traj_t, traj_j), (s_t, s_j)):
        assert max_abs(got, want) < 1e-4
