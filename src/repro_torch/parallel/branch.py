"""Branch Parallelism (paper §4.2, Fig. 4) over rank processes (counterpart
of ``repro/parallel/branch.py``).

The paper's BP gives each dependency-free branch of a block to a device
group; GPU frameworks realise it as MPMD, with broadcast and all-reduce.
That is what runs here: the rank at coordinate i of the ``branch`` axis
computes only branch i, every other branch contributes zeros of its output's
shape, and one all-reduce over the axis (:func:`collectives.psum`) is the
exchange, the reference's ``lax.psum`` of its ``lax.cond`` arms.  Its
backward is an all-reduce of the cotangents, the paper's backward broadcast
and all-reduce.

BP does not split activations ("the same computational intensity is
retained", §4.2): every rank of the axis holds the full inputs.  The branches
draw their dropout from sub-streams 0 and 1 of the block's rng, as the
serial block does, so a BP block equals the serial one with dropout too.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core import evoformer as evo
from repro_torch.core.config import EvoformerConfig
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.mesh_utils import Axis


def branch_parallel(branches: Sequence[Callable], like: Sequence[tuple], *,
                    axis: Axis) -> Callable:
    """BP combinator.  ``branches`` are thunks, branch i returning a tuple of
    tensors shaped and typed as the tensors of ``like[i]``.  Returns a thunk
    giving every branch's outputs, in order, on every rank of ``axis``: this
    rank runs only the branch at its coordinate and receives the others
    through one all-reduce."""
    if len(branches) != axis.size:
        raise ValueError(f"{len(branches)} branches over a branch axis of "
                         f"extent {axis.size}")

    def run():
        outs = []
        for i, (fn, protos) in enumerate(zip(branches, like)):
            if i == axis.index:
                got = tuple(fn())
                if len(got) != len(protos):
                    raise ValueError(f"branch {i} returned {len(got)} "
                                     f"tensors, expected {len(protos)}")
                outs += got
            else:
                outs += [torch.zeros(t.shape, dtype=t.dtype, device=t.device)
                         for t in protos]
        return coll.psum(tuple(outs), axis)
    return run


def _reject_masks(masks):
    if masks is not None:
        raise ValueError(
            "Branch Parallelism is a training layout; padded-bucket masks "
            "are an inference feature — inference plans fold the branch "
            "extent into data parallelism (ParallelPlan.for_inference), so "
            "route masked folds through a serial or dap block_fn")


def _require_parallel(cfg: EvoformerConfig, what: str):
    if cfg.variant != "parallel":
        raise ValueError(
            f"{what} requires the 'parallel' Evoformer variant (got "
            f"{cfg.variant!r}): serial variants have a cross-branch "
            "dependency inside the block (paper §4.1)")


def bp_evoformer_block(p: evo.EvoformerBlock, cfg: EvoformerConfig, msa, z,
                       *, axis: Axis, rng: evo.Rng = None,
                       deterministic: bool = True, masks=None):
    """Branch-parallel Parallel-Evoformer block (Fig. 4).  Branch 0: the
    MSA stack and the outer-product mean; branch 1: the pair stack.  The
    exchange lands ``z_out = pair_branch(z) + OPM(msa_out)``."""
    _reject_masks(masks)
    _require_parallel(cfg, "Branch Parallelism")
    kw = dict(deterministic=deterministic)

    def branch_msa():
        msa_out = evo.msa_branch(p, cfg, msa, z, rng=evo.fold_in(rng, 0), **kw)
        return msa_out, evo.opm_apply(p.opm, cfg, msa_out).to(z.dtype)

    def branch_pair():
        return (evo.pair_branch(p, cfg, z, rng=evo.fold_in(rng, 1),
                                **kw).to(z.dtype),)

    msa_out, opm, z_pair = branch_parallel(
        [branch_msa, branch_pair], [(msa, z), (z,)], axis=axis)()
    return msa_out, z_pair + opm


def bp_dap_evoformer_block(p: evo.EvoformerBlock, cfg: EvoformerConfig,
                           msa_l, z_l, *, branch_axis: Axis, dap_axis: Axis,
                           rng: evo.Rng = None, deterministic: bool = True,
                           n_seq_total=None, masks=None):
    """Hybrid BP x DAP block (paper §4.3, Table 6).  The inputs are DAP
    shards, the same on both branch coordinates.  Branch 0 runs the DAP MSA
    stack and OPM over its own ``dap`` group, branch 1 the DAP pair stack:
    the ranks of one dap group all take the same branch, so its collectives
    match."""
    from repro_torch.parallel import dap as dap_lib
    _reject_masks(masks)
    _require_parallel(cfg, "hybrid BP x DAP")
    kw = dict(deterministic=deterministic, axis=dap_axis)

    def branch_msa():
        msa_out = dap_lib.dap_msa_branch(p, cfg, msa_l, z_l,
                                         rng=evo.fold_in(rng, 0), **kw)
        opm = dap_lib.dap_outer_product_mean(
            p.opm, msa_out, dap_axis, n_seq_total, row_chunk=cfg.opm_chunk,
            opm_impl=cfg.opm_impl)
        return msa_out, opm.to(z_l.dtype)

    def branch_pair():
        return (dap_lib.dap_pair_branch(p, cfg, z_l, rng=evo.fold_in(rng, 1),
                                        **kw).to(z_l.dtype),)

    msa_out, opm, z_pair = branch_parallel(
        [branch_msa, branch_pair], [(msa_l, z_l), (z_l,)],
        axis=branch_axis)()
    return msa_out, z_pair + opm
