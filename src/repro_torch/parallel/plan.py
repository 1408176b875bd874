"""ParallelPlan: the one declarative description of how an AF2 training
step is laid out over rank processes (counterpart of
``repro/parallel/plan.py``).

A plan names one point of the paper's strategy matrix — Parallel Evoformer
with Branch Parallelism, hybridised with DAP (§4.3, Table 6) — over data
parallelism:

    pod x data        data-parallel extents (gradient means)
    branch            Branch Parallelism extent (1 or 2, paper §4.2)
    dap               Dynamic Axial Parallelism extent (FastFold, §3.2)
    variant / attention_impl / opm_impl / tri_mult_impl / remat
                      Evoformer implementation choices (None: keep cfg's)
    compress_pod_grads int8 error feedback on the cross-pod gradient sum
    overlap_dap       the communication-overlapped DAP schedule

``plan.build(...)`` validates it and returns a :class:`BuiltPlan` — the
mesh, the ``block_fn`` / ``stack_io`` the model runs, ``grad_sync`` and this
rank's data-parallel coordinates — which is all the train step and the
launchers consume.  One process runs each rank: the mesh is a
``DeviceMesh`` over the world's ranks (``parallel.mesh_utils``), and every
rank builds the same plan.  ``auto_plan`` picks the DP x BP x DAP split from
the roofline cost model (``analysis.roofline``, H100 constants).

Plans serialise (``to_dict`` / ``from_dict``); checkpoints record the plan
and the mesh fingerprint (:meth:`BuiltPlan.metadata`) and refuse a restore
under a different plan unless asked to adapt.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.parallel import collectives as coll
from repro_torch.parallel.mesh_utils import (Axis, make_mesh, mesh_shape,
                                             refactor_mesh)

_VARIANTS = ("af2", "multimer", "parallel")
_ATTENTION_IMPLS = ("reference", "chunked", "pallas", "evo_pallas")
_OPM_IMPLS = ("fused", "naive")
_TRI_MULT_IMPLS = ("reference", "chunked", "pallas")
_REMATS = ("none", "block", "dots")

# parameters whose gradients are PARTIAL across the branch / dap ranks and
# need the completing sum: the stacks and everything upstream of them (the
# embedder — each rank's backward carries only its branch's or its shard's
# cotangent back to the stack inputs).  'single_proj' is the exception: it
# reads the exchanged (replicated) stack output, so its gradient is already
# complete, and summing it would multiply it by the group size.
PARTIAL_GRAD_KEYS = ("evoformer", "extra_stack", "embedder")
COMPLETE_EMBEDDER_KEYS = ("single_proj",)


class PlanError(ValueError):
    """A ParallelPlan that cannot run; the message says how to fix it."""


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    pod: int = 1
    data: int = 1
    branch: int = 1
    dap: int = 1
    variant: Optional[str] = None
    attention_impl: Optional[str] = None
    opm_impl: Optional[str] = None
    tri_mult_impl: Optional[str] = None
    remat: Optional[str] = None
    compress_pod_grads: bool = False
    # None: on for dap > 1 on a pure-DAP group of the 'parallel' variant
    # (the only variant whose two branches both read the block-input pair
    # rep); the hybrid and the serial variants keep the sync schedule
    overlap_dap: Optional[bool] = None

    @property
    def n_devices(self) -> int:
        return self.pod * self.data * self.branch * self.dap

    @property
    def group(self) -> int:
        """Ranks cooperating on one protein (the model-parallel extent)."""
        return self.branch * self.dap

    def describe(self) -> str:
        parts = [f"dp={self.pod * self.data}"
                 + (f" (pod={self.pod} x data={self.data})" if self.pod > 1
                    else "")]
        parts.append(f"bp={self.branch}")
        parts.append(f"dap={self.dap}")
        for k in ("variant", "attention_impl", "opm_impl", "tri_mult_impl",
                  "remat"):
            v = getattr(self, k)
            if v is not None:
                parts.append(f"{k}={v}")
        if self.compress_pod_grads:
            parts.append("compress_pod_grads")
        if self.overlap_dap is not None:
            parts.append(f"overlap_dap={'on' if self.overlap_dap else 'off'}")
        return f"ParallelPlan[{' '.join(parts)}] ({self.n_devices} devices)"

    # -- construction helpers ------------------------------------------------

    @classmethod
    def from_flags(cls, n_devices: int, *, bp: int = 1, dap: int = 1,
                   pod: int = 1, **kw) -> "ParallelPlan":
        """The ``(--bp, --dap, --pods)`` launcher surface: whatever the model
        extents leave over becomes data parallelism."""
        group = bp * dap * pod
        if group <= 0 or n_devices % group:
            raise PlanError(
                f"pod({pod}) x bp({bp}) x dap({dap}) = {group} does not "
                f"divide the {n_devices} available devices; pick extents "
                f"whose product divides the device count")
        return cls(pod=pod, data=n_devices // group, branch=bp, dap=dap, **kw)

    @classmethod
    def for_mesh(cls, mesh: DeviceMesh, *, branch: int = 1, dap: int = 1,
                 **kw) -> "ParallelPlan":
        """The plan of an existing mesh: pod and data read off it; its
        'model' axis must factor as branch x dap (``build`` refactors it)."""
        shape = mesh_shape(mesh)
        return cls(pod=shape.get("pod", 1), data=shape.get("data", 1),
                   branch=branch, dap=dap, **kw)

    def for_inference(self) -> "ParallelPlan":
        """The inference layout of a training plan: ``branch`` and ``pod``
        fold into ``data`` (a forward-only branch split halves each rank's
        use, the same ranks double the folds as data parallelism), remat
        goes (there is no backward), ``dap`` and ``overlap_dap`` stay (the
        pair rep is the memory wall either way)."""
        return dataclasses.replace(
            self, pod=1, data=self.pod * self.data * self.branch, branch=1,
            remat="none", compress_pod_grads=False)

    # -- config interaction --------------------------------------------------

    def apply_to(self, cfg):
        """``cfg`` with this plan's non-None implementation choices applied
        to both Evoformer stacks (and the model's remat)."""
        evo_over = {k: v for k, v in (
            ("variant", self.variant),
            ("attention_impl", self.attention_impl),
            ("opm_impl", self.opm_impl),
            ("tri_mult_impl", self.tri_mult_impl)) if v is not None}
        over = {}
        if evo_over:
            over["evoformer"] = dataclasses.replace(cfg.evoformer, **evo_over)
            over["extra"] = dataclasses.replace(cfg.extra, **evo_over)
        if self.remat is not None:
            over["remat"] = self.remat
        return dataclasses.replace(cfg, **over) if over else cfg

    def _effective_variant(self, cfg=None) -> Optional[str]:
        if self.variant is not None:
            return self.variant
        return cfg.evoformer.variant if cfg is not None else None

    def resolve_overlap(self, cfg=None) -> bool:
        """The DAP schedule built: an explicit ``overlap_dap`` wins; None is
        on for dap > 1, branch 1 and the 'parallel' variant, and off when
        the variant is unknown (the sync schedule is always right)."""
        if self.overlap_dap is not None:
            return self.overlap_dap
        return (self.dap > 1 and self.branch == 1
                and self._effective_variant(cfg) == "parallel")

    # -- validation ----------------------------------------------------------

    def validate(self, cfg=None) -> "ParallelPlan":
        for k in ("pod", "data", "branch", "dap"):
            v = getattr(self, k)
            if not isinstance(v, int) or v < 1:
                raise PlanError(f"plan.{k} must be a positive int, got {v!r}")
        if self.branch not in (1, 2):
            raise PlanError(
                f"plan.branch must be 1 or 2, got {self.branch}: the "
                "Parallel Evoformer block has exactly two dependency-free "
                "branches (MSA+OPM and pair, paper §4.2)")
        variant = self._effective_variant(cfg)
        if self.branch > 1 and variant not in (None, "parallel"):
            raise PlanError(
                f"branch parallelism (branch={self.branch}) requires the "
                f"'parallel' Evoformer variant, got {variant!r}: serial "
                "variants have a cross-branch dependency inside the block "
                "(paper §4.1) — set plan.variant='parallel'")
        for field, allowed in (("variant", _VARIANTS),
                               ("attention_impl", _ATTENTION_IMPLS),
                               ("opm_impl", _OPM_IMPLS),
                               ("tri_mult_impl", _TRI_MULT_IMPLS),
                               ("remat", _REMATS)):
            v = getattr(self, field)
            if v is not None and v not in allowed:
                raise PlanError(f"plan.{field}={v!r} is not one of {allowed}")
        if self.compress_pod_grads and self.pod == 1:
            raise PlanError(
                "compress_pod_grads targets the cross-pod gradient hop but "
                "the plan has pod=1 — set pod>1 (e.g. --pods 2) or drop "
                "compression")
        if self.overlap_dap:
            if self.dap < 2:
                raise PlanError(
                    "overlap_dap=True overlaps DAP's collectives with "
                    f"compute, but the plan has dap={self.dap} (no DAP "
                    "collectives to overlap) — raise dap or leave "
                    "overlap_dap=None")
            if self.branch > 1:
                raise PlanError(
                    f"overlap_dap=True is not supported under the BP x DAP "
                    f"hybrid (branch={self.branch}): the branch dispatch "
                    "precludes the shared prefetch carry — leave "
                    "overlap_dap=None (the hybrid keeps the sync schedule)")
            if variant not in (None, "parallel"):
                raise PlanError(
                    f"overlap_dap=True requires the 'parallel' Evoformer "
                    f"variant, got {variant!r}: only the parallel block "
                    "feeds BOTH branches the block-input pair rep, the "
                    "invariant the prefetched gather relies on — set "
                    "plan.variant='parallel' or leave overlap_dap=None")
        if cfg is not None and self.dap > 1:
            for name, extent in (("n_seq", cfg.n_seq),
                                 ("n_extra_seq", cfg.n_extra_seq),
                                 ("n_res", cfg.n_res)):
                if extent % self.dap:
                    ok = [d for d in range(2, extent + 1)
                          if cfg.n_seq % d == 0 and cfg.n_extra_seq % d == 0
                          and cfg.n_res % d == 0][:6]
                    raise PlanError(
                        f"dap={self.dap} does not divide cfg.{name}="
                        f"{extent}; DAP shards must be equal on every "
                        f"device (feasible dap extents for this config: "
                        f"{ok or 'none'})")
        return self

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ParallelPlan":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise PlanError(f"unknown ParallelPlan fields {sorted(unknown)} "
                            f"(known: {sorted(known)})")
        return cls(**d)

    # -- build ---------------------------------------------------------------

    def build(self, mesh=None, *, cfg=None, device=None) -> "BuiltPlan":
        """Materialise the plan on this rank.  ``mesh``: None (a plan of one
        device needs no mesh; a larger one takes every rank of the world),
        a sequence of global ranks (a fresh mesh over them), or an existing
        ``DeviceMesh`` whose 'model' axis is refactored into branch x dap.
        Every rank of the world calls ``build`` with the same arguments (a
        mesh creates process groups), also a rank outside the mesh.
        ``device``: where this rank computes (the route table and the
        fingerprint's platform)."""
        self.validate(cfg)
        device = torch.device(device if device is not None else "cpu")
        if isinstance(mesh, DeviceMesh):
            mesh = self._adapt_mesh(mesh)
        elif self.n_devices == 1 and mesh is None:
            mesh = None
        else:
            mesh = self._make_mesh(mesh)
        return _build(self, mesh, cfg, device)

    def _make_mesh(self, ranks: Optional[Sequence[int]]) -> DeviceMesh:
        n = self.n_devices
        if not (dist.is_available() and dist.is_initialized()):
            raise PlanError(
                f"plan covers {n} devices but torch.distributed is not "
                "initialised: start one process per rank (launch.train "
                "--devices N, or torchrun) before building it")
        ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
        if len(ranks) != n:
            raise PlanError(
                f"plan covers {n} devices (pod={self.pod} data={self.data} "
                f"branch={self.branch} dap={self.dap}) but {len(ranks)} "
                f"ranks were given; fix the extents (ParallelPlan.from_flags "
                f"derives data from the rank count) or pass ranks[:{n}]")
        axes = [(name, ext) for name, ext in (
            ("pod", self.pod), ("data", self.data), ("branch", self.branch),
            ("dap", self.dap)) if ext > 1 or name == "data"]
        return make_mesh([e for _, e in axes], [a for a, _ in axes],
                         ranks=ranks)

    def _adapt_mesh(self, mesh: DeviceMesh) -> DeviceMesh:
        """Fit the plan onto a mesh (pod?, data, model): 'model' factors into
        (branch, dap); a model axis with no model parallelism in the plan
        stays as an idle replicated axis."""
        shape = mesh_shape(mesh)
        for name in ("pod", "data"):
            extent = shape.get(name, 1)
            if extent != getattr(self, name):
                raise PlanError(
                    f"plan.{name}={getattr(self, name)} but the mesh has "
                    f"{name} extent {extent}; use ParallelPlan.for_mesh to "
                    "derive DP extents from the mesh")
        if "model" in shape:
            model = shape["model"]
            if self.group == 1:
                return mesh
            if self.group != model:
                raise PlanError(
                    f"branch({self.branch}) x dap({self.dap}) = {self.group} "
                    f"!= mesh 'model' axis extent {model}; the logical "
                    "refactoring must cover the physical axis exactly")
            split = [(n, e) for n, e in (("branch", self.branch),
                                         ("dap", self.dap)) if e > 1]
            return refactor_mesh(mesh, {"model": split})
        for name in ("branch", "dap"):
            extent = shape.get(name, 1)
            if extent != getattr(self, name):
                raise PlanError(
                    f"plan.{name}={getattr(self, name)} but the mesh has "
                    f"{name} extent {extent}")
        return mesh

    def fingerprint(self, mesh: Optional[DeviceMesh], device="cpu") -> dict:
        """Mesh identity for checkpoint metadata: enough to notice a changed
        topology without pinning ranks."""
        return {"n_devices": int(mesh.mesh.numel()) if mesh is not None else 1,
                "axes": mesh_shape(mesh) or {"data": 1},
                "platform": torch.device(device).type}


def as_plan(plan) -> ParallelPlan:
    """What the port's entry points take as their plan: a ``ParallelPlan``,
    or None for the one-device plan; anything else raises TypeError."""
    if plan is None:
        return ParallelPlan()
    if not isinstance(plan, ParallelPlan):
        raise TypeError(
            f"expected a ParallelPlan or None, got {type(plan).__name__}: "
            "construct one with ParallelPlan(...), "
            "ParallelPlan.from_flags(...) or auto_plan(...)")
    return plan


# ---------------------------------------------------------------------------
# BuiltPlan: what the train step consumes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BuiltPlan:
    plan: ParallelPlan
    mesh: Optional[DeviceMesh]
    device: torch.device
    dp_axes: tuple                  # names of the gradient-mean axes
    sync_axes: tuple                # names of the partial-gradient sum axes
    block_fn: Optional[Callable]    # Evoformer block override (None: serial)
    stack_io: Optional[tuple]       # (pre, post) around each stack
    grad_sync: Callable             # (grads, err, *, completed) -> (grads, err)

    def axis(self, name: str) -> Axis:
        return Axis(self.mesh, name)

    @property
    def in_mesh(self) -> bool:
        """Whether this rank belongs to the plan's mesh."""
        return self.mesh is None or self.mesh.get_coordinate() is not None

    @property
    def ranks(self) -> Optional[list]:
        """The mesh's global ranks in mesh order (None: no mesh)."""
        return None if self.mesh is None else self.mesh.mesh.flatten().tolist()

    @property
    def is_writer(self) -> bool:
        """Whether this rank writes what the plan's ranks share (the mesh's
        first rank; checkpoints)."""
        return self.mesh is None or self.ranks[0] == dist.get_rank()

    def barrier(self) -> None:
        """Wait for every rank of the mesh: a barrier over each axis's
        group in turn."""
        for name in mesh_shape(self.mesh):
            if self.axis(name).size > 1:
                dist.barrier(group=self.axis(name).group)

    @property
    def dp_size(self) -> int:
        return coll.axes_size([self.axis(a) for a in self.dp_axes])

    @property
    def dp_rank(self) -> int:
        """This rank's data-parallel replica, over (pod, data)."""
        return coll.dp_index([self.axis(a) for a in self.dp_axes])

    def local_rows(self, n: int) -> slice:
        """This replica's rows of a global batch of ``n`` proteins."""
        if n % self.dp_size:
            raise PlanError(f"a global batch of {n} does not split over "
                            f"{self.dp_size} data-parallel replicas")
        k = n // self.dp_size
        return slice(self.dp_rank * k, (self.dp_rank + 1) * k)

    @property
    def backend(self) -> Optional[str]:
        return None if self.mesh is None else dist.get_backend()

    def routes(self) -> dict:
        """How each collective kind runs on this plan's groups ({} for no
        mesh): ``collectives.routes`` of the world's backend."""
        if self.mesh is None:
            return {}
        return coll.routes(None, self.device)

    def metadata(self) -> dict:
        return {"plan": self.plan.to_dict(),
                "mesh_fingerprint": self.plan.fingerprint(self.mesh,
                                                          self.device)}


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, factor, msa, z):
        ctx.factor = factor
        return msa.view_as(msa), z.view_as(z)

    @staticmethod
    def backward(ctx, cm, cz):
        return None, cm * ctx.factor, cz * ctx.factor


def _region_exit_fn(factor: float):
    """Identity on (msa, z) whose backward scales the cotangents by
    ``factor``, at the exit of the branch/dap-parallel region (the stacks).

    Downstream of the region (structure module, heads, loss) every rank of
    the group computes the FULL cotangent, while the collective transposes
    inside it (psum -> psum, all_gather -> reduce-scatter) take partial
    cotangents that SUM to the true one over the group.  Scaling by 1/group
    at the boundary converts one convention into the other; without it
    every exchange would multiply the upstream gradients by the group size
    (hidden by Adam's scale invariance, caught by an SGD comparison)."""
    return lambda msa, z: _ScaleGrad.apply(factor, msa, z)


def partial_grad_key(key: str) -> bool:
    """Whether the gradient of parameter ``key`` (a key path) is partial
    across the branch / dap ranks."""
    top, _, rest = key.partition(".")
    return (top in PARTIAL_GRAD_KEYS and not (
        top == "embedder" and rest.split(".")[0] in COMPLETE_EMBEDDER_KEYS))


def complete_partial_grads(grads: dict, sync_axes: Sequence[Axis]) -> dict:
    """Sum the PARTIAL gradients over the branch / dap axes: the stacks and
    everything upstream of them, minus the exchanged ``single_proj``.  Used
    by ``grad_sync`` and by the train step, which completes each protein's
    gradient before measuring (and clipping) its norm."""
    if not sync_axes:
        return grads
    part = coll.psum_tree({k: g for k, g in grads.items()
                           if partial_grad_key(k)}, sync_axes)
    return {k: part.get(k, g) for k, g in grads.items()}


def _build(plan: ParallelPlan, mesh, cfg, device) -> BuiltPlan:
    from repro_torch.parallel import branch as bp_lib
    from repro_torch.parallel import dap as dap_lib
    from repro_torch.parallel import grad_sync as gs_lib

    names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    have_branch = plan.branch > 1 and "branch" in names
    have_dap = plan.dap > 1 and "dap" in names
    branch_ax, dap_ax = Axis(mesh, "branch"), Axis(mesh, "dap")

    block_fn = None
    if have_branch and have_dap:
        # n_seq_total None: each stack's row count from its shard
        block_fn = functools.partial(bp_lib.bp_dap_evoformer_block,
                                     branch_axis=branch_ax, dap_axis=dap_ax)
    elif have_branch:
        block_fn = functools.partial(bp_lib.bp_evoformer_block,
                                     axis=branch_ax)
    elif have_dap:
        block_fn = dap_lib.make_dap_block_fn(
            dap_ax, overlap=plan.resolve_overlap(cfg))

    sync_names = ((("branch",) if have_branch else ()) +
                  (("dap",) if have_dap else ()))
    sync = tuple(Axis(mesh, a) for a in sync_names)
    dps = tuple(Axis(mesh, a) for a in dp_axes)
    group = coll.axes_size(sync)
    stack_io = None
    if group > 1:
        exit_fn = _region_exit_fn(1.0 / group)
        if have_dap:
            def pre(m, z):
                return dap_lib.shard_inputs(m, z, dap_ax)

            def post(m, z):
                return exit_fn(*dap_lib.unshard_outputs(m, z, dap_ax))
        else:
            def pre(m, z):
                return m, z
            post = exit_fn
        stack_io = (pre, post)

    compress = plan.compress_pod_grads and "pod" in names
    pod_ax = Axis(mesh, "pod")

    def grad_sync(grads: dict, err: Optional[dict] = None, *,
                  completed: bool = False):
        """Complete and reduce gradients: the partial gradients (stacks and
        embedder) are summed over the sync axes unless ``completed`` (the
        train step completes each protein's gradient itself), then every
        gradient is averaged over the DP axes — on the pod hop int8
        error-feedback compressed when the plan says so."""
        if not completed:
            grads = complete_partial_grads(grads, sync)
        if compress and err is not None:
            inner = [a for a in dps if a.name != "pod"]
            grads = coll.pmean_tree(grads, inner)
            grads, err = gs_lib.compressed_psum_tree(grads, pod_ax, err)
            grads = {k: g / pod_ax.size for k, g in grads.items()}
        elif dps:
            grads = coll.pmean_tree(grads, dps)
        return grads, err

    return BuiltPlan(plan=plan, mesh=mesh, device=device, dp_axes=dp_axes,
                     sync_axes=sync_names, block_fn=block_fn,
                     stack_io=stack_io, grad_sync=grad_sync)


# ---------------------------------------------------------------------------
# auto_plan: the split from the roofline cost model
# ---------------------------------------------------------------------------

def _divisors(n: int):
    return [d for d in range(1, n + 1) if n % d == 0]


def auto_plan(n_devices: int, cfg, *, global_batch: int = 128, pod: int = 1,
              hw=None, **plan_kw) -> ParallelPlan:
    """The DP x BP x DAP split for ``n_devices`` and a model config.

    Data parallelism is free and the batch is its limit, so the group per
    protein is the SMALLEST extent that lets every device take part
    (``n_devices / dp <= global_batch``); within a group the (bp, dap)
    factorisation with the least roofline block time
    (``analysis.roofline.estimate_block_time``) wins."""
    from repro_torch.analysis.roofline import HW, estimate_block_time
    hw = hw or HW()
    if n_devices < 1:
        raise PlanError(f"n_devices must be >= 1, got {n_devices}")
    if pod < 1 or n_devices % pod:
        raise PlanError(f"pod={pod} does not divide n_devices={n_devices}")
    per_pod = n_devices // pod
    variant = plan_kw.get("variant") or cfg.evoformer.variant
    want_overlap = plan_kw.get("overlap_dap")
    infeasible = []
    for group in _divisors(per_pod):
        dp = pod * (per_pod // group)
        if dp > global_batch or global_batch % dp:
            continue
        cands = []
        for bp in (2, 1):
            if group % bp:
                continue
            dap = group // bp
            if bp > 1 and variant != "parallel":
                infeasible.append(f"bp={bp} (variant={variant!r})")
                continue
            if bp > 1 and want_overlap:
                infeasible.append(f"bp={bp} (overlap_dap=True)")
                continue
            if any(extent % dap for extent in
                   (cfg.n_seq, cfg.n_extra_seq, cfg.n_res)):
                infeasible.append(f"dap={dap} (indivisible shapes)")
                continue
            ov = (want_overlap if want_overlap is not None else
                  (bp == 1 and dap > 1 and variant == "parallel"))
            t = estimate_block_time(cfg, bp=bp, dap=dap, hw=hw, overlap=ov)
            cands.append((t, bp, dap))
        if not cands:
            continue
        _, bp, dap = min(cands)
        return ParallelPlan(pod=pod, data=per_pod // group, branch=bp,
                            dap=dap, **plan_kw).validate(cfg)
    raise PlanError(
        f"no feasible plan for {n_devices} devices, global_batch="
        f"{global_batch}, pod={pod}"
        + (f" (rejected: {sorted(set(infeasible))})" if infeasible else "")
        + "; lower the device count, raise the batch, or pick extents "
        "explicitly with ParallelPlan.from_flags")
