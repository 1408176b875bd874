"""The production mesh and its logical refactorings (counterpart of
``repro/launch/mesh.py``), as ``DeviceMesh``es over the ranks of the world.

The physical mesh keeps the reference's shape, so that the dry run's
records compare with the reference's: (data, model) = (16, 16) per pod, and
a pod axis in front for two pods, (2, 16, 16).  On H100s a pod is 256
cards, 32 nodes of 8; the 'model' axis of 16 then spans two NVLink domains
of 8.  The dry run (``launch/dryrun.py``) builds these meshes inside a
virtual world (``parallel.ranks.virtual_world``) of 256 or 512 ranks.
Logical views:

* LM archs: 'model' = tensor/expert parallel, 'pod' folds into data
  parallelism.
* AlphaFold2: the 'model' axis factors into ('branch', 'dap') according to
  a ``parallel.plan.ParallelPlan``: ``plan.build(mesh)`` performs the
  refactoring (the paper's BP=2 x DAP=8 hybrid, §4.3, is
  ``ParallelPlan.for_mesh(mesh, branch=2, dap=8)``).

Every rank of the world builds each mesh, in the same order (a mesh creates
process groups).
"""
from __future__ import annotations

import os

from repro_torch.parallel.mesh_utils import (make_mesh, mesh_shape,
                                             refactor_mesh)


def production_shape(multi_pod: bool = False) -> tuple:
    """((extents), (axis names)) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def shape_from_env(multi_pod: bool = False,
                   env: str = "REPRO_DRYRUN_MESH") -> tuple:
    """The production mesh's (extents, names), or the override
    ``REPRO_DRYRUN_MESH="AxB[xC]"`` (the last two axes data and model, a
    third in front the pod axis), e.g. ``8x1`` for a mesh of 8 data ranks
    with no model axis to speak of."""
    override = os.environ.get(env)
    if override:
        dims = tuple(int(x) for x in override.split("x"))
        return dims, ("pod", "data", "model")[-len(dims):]
    return production_shape(multi_pod)


def make_production_mesh(*, multi_pod: bool = False):
    return make_mesh(*production_shape(multi_pod))


def production_mesh_from_env(multi_pod: bool = False,
                             env: str = "REPRO_DRYRUN_MESH"):
    """The production mesh, overridable via ``REPRO_DRYRUN_MESH``
    (:func:`shape_from_env`)."""
    return make_mesh(*shape_from_env(multi_pod, env))


def af2_logical_mesh(mesh, *, bp: int = 2, dap: int = 8):
    """(..., data, model) -> (..., data, branch, dap) with branch * dap =
    model.  ``ParallelPlan.build`` performs the same refactoring as part of
    building the full execution plan."""
    model = mesh_shape(mesh)["model"]
    if bp * dap != model:
        raise ValueError(f"bp({bp}) * dap({dap}) != model axis ({model})")
    split = [("branch", bp), ("dap", dap)] if bp > 1 else [("dap", dap)]
    if dap == 1 and bp > 1:
        split = [("branch", bp)]
    return refactor_mesh(mesh, {"model": split})


def dp_axes_of(mesh) -> tuple:
    names = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)
