"""Named mesh axes over rank processes (counterpart of
``repro/parallel/mesh_utils.py``).

The reference runs one program over a named device mesh (``shard_map``); the
port runs one process per rank, and a
``torch.distributed.device_mesh.DeviceMesh`` names the axes (``pod``,
``data``, ``branch``, ``dap``).  ``jax.lax.axis_index(a)`` becomes the
mesh's local rank on ``a`` and a collective over ``a`` runs in that axis's
process group (:class:`Axis`).  The reference's ``smap`` has no counterpart:
each process runs its own rank's program.

Building a mesh creates process groups, so every rank of the world calls
each mesh constructor here, in the same order, even a rank outside the mesh.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def mesh_device_type(backend: str) -> str:
    """The DeviceMesh device type of a backend: ``cuda`` for NCCL; ``cpu``
    for gloo, whose groups serve CPU ranks and ranks sharing one card (the
    mesh only names the groups; tensors keep their own devices)."""
    return "cuda" if backend == "nccl" else "cpu"


def make_mesh(shape: Sequence[int], names: Sequence[str], *,
              ranks: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A mesh of ``shape`` named ``names`` over ``ranks`` (global ranks in
    mesh order; default every rank of the world).  Earlier axes are outer."""
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else list(ranks)
    if len(ranks) != math.prod(shape):
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} ranks, "
                         f"got {len(ranks)}")
    return DeviceMesh(mesh_device_type(dist.get_backend()),
                      torch.tensor(ranks, dtype=torch.int).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


# what a mesh says of itself, kept by id with a weak reference to the mesh
# (a DeviceMesh rebuilds its rank tensor at each ``.mesh``, ~0.2 ms, and a
# step asks its axes' extents thousands of times)
_MESH_FACTS: dict = {}


def _facts(mesh: DeviceMesh) -> dict:
    key = id(mesh)
    hit = _MESH_FACTS.get(key)
    if hit is None or hit[0]() is not mesh:
        gone = lambda _, key=key: _MESH_FACTS.pop(key, None)
        hit = (weakref.ref(mesh, gone), {"shape": {
            n: int(s) for n, s in zip(mesh.mesh_dim_names, mesh.mesh.shape)}})
        _MESH_FACTS[key] = hit
    return hit[1]


def mesh_shape(mesh: Optional[DeviceMesh]) -> dict:
    """{axis name: extent} of ``mesh`` ({} for no mesh)."""
    if mesh is None:
        return {}
    return dict(_facts(mesh)["shape"])


def refactor_mesh(mesh: DeviceMesh,
                  split: Mapping[str, Sequence[tuple]]) -> DeviceMesh:
    """Split named axes: ``refactor_mesh(m, {"model": [("branch", 2),
    ("dap", 8)]})``, over the same rank order.  Axes not mentioned keep
    their name and extent; sub-axis sizes must multiply to the split axis's
    extent; earlier sub-axes are outer."""
    new_shape, new_names = [], []
    for name, extent in mesh_shape(mesh).items():
        if name in split:
            subs = list(split[name])
            prod = math.prod(s for _, s in subs)
            if prod != extent:
                raise ValueError(
                    f"split of axis {name!r} (extent {extent}) into {subs} "
                    f"multiplies to {prod}")
            new_names += [n for n, _ in subs]
            new_shape += [s for _, s in subs]
        else:
            new_names.append(name)
            new_shape.append(extent)
    return DeviceMesh(mesh.device_type, mesh.mesh.reshape(tuple(new_shape)),
                      mesh_dim_names=tuple(new_names))


def merged_axis(mesh: Optional[DeviceMesh], names: Sequence[str]) -> "Axis":
    """One :class:`Axis` over the adjacent axes ``names`` of ``mesh`` taken
    together (outer first; e.g. ("pod", "data"), the LM step's data
    parallelism across pods): the axis itself where only one of them is
    wider than 1, else a mesh over the same ranks with them merged (a new
    mesh: every rank calls this together)."""
    ext = mesh_shape(mesh)
    wide = [n for n in names if ext.get(n, 1) > 1]
    if len(wide) <= 1:
        return Axis(mesh, wide[0] if wide else names[-1])
    order = list(ext)
    at = [order.index(n) for n in names]
    if at != list(range(at[0], at[0] + len(at))):
        raise ValueError(f"axes {tuple(names)} are not adjacent in {order}")
    joined = "*".join(names)
    new_names = order[:at[0]] + [joined] + order[at[-1] + 1:]
    new_shape = [ext[n] for n in order[:at[0]]] + [
        math.prod(ext[n] for n in names)] + [ext[n] for n in
                                             order[at[-1] + 1:]]
    return Axis(DeviceMesh(mesh.device_type,
                           mesh.mesh.reshape(tuple(new_shape)),
                           mesh_dim_names=tuple(new_names)), joined)


def rename_mesh(mesh: DeviceMesh, renames: Mapping[str, str]) -> DeviceMesh:
    names = tuple(renames.get(n, n) for n in mesh.mesh_dim_names)
    return DeviceMesh(mesh.device_type, mesh.mesh, mesh_dim_names=names)


def axis_size(mesh: Optional[DeviceMesh], name: str) -> int:
    return 1 if mesh is None else _facts(mesh)["shape"].get(name, 1)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One named axis of a mesh as this rank sees it: its extent, this
    rank's coordinate on it, and the process group of the ranks that share
    every other coordinate with this one.  An axis the mesh lacks (or no
    mesh) has extent 1 and no group."""
    mesh: Optional[DeviceMesh]
    name: str

    @property
    def size(self) -> int:
        return axis_size(self.mesh, self.name)

    @property
    def index(self) -> int:
        if self.size == 1:
            return 0
        facts = _facts(self.mesh)
        key = ("index", self.name)
        if key not in facts:
            facts[key] = self.mesh.get_local_rank(self.name)
        return facts[key]

    @property
    def group(self):
        if self.size == 1:
            return None
        facts = _facts(self.mesh)
        key = ("group", self.name)
        if key not in facts:
            facts[key] = self.mesh.get_group(self.name)
        return facts[key]


def axis_extent(axis: Axis) -> int:
    """Extent of a mesh axis (the reference's ``axis_extent`` inside
    ``shard_map``)."""
    return axis.size


def local_slice(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's equal slice of ``x`` along ``dim``."""
    size = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * size, size)
