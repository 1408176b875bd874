"""Full AlphaFold2 model: embedder -> extra-MSA stack -> Evoformer stack ->
structure module -> heads, with recycling (counterpart of
``repro/core/model.py``).

Single-protein functions, as in the reference; ``fold_cycle`` loops over the
batch where the reference vmaps.  Two paths:

* training — :func:`forward` and :func:`loss_fn`: ``n_recycle - 1`` cycles
  without gradients, then one cycle with them; dropout when
  ``deterministic=False``; ``remat="block"`` recomputes each Evoformer block
  in the backward (``torch.utils.checkpoint``), ``remat="dots"`` keeps the
  outputs of its plain 2-D products and recomputes the rest.
* serving — :func:`predict`: forward-only under ``torch.no_grad`` with no
  checkpointing (the reference's inference plan sets ``remat="none"``), and
  adaptive early-exit recycling.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    set_checkpoint_early_stop)

from repro_torch.core import evoformer as evo
from repro_torch.core import heads as heads_lib
from repro_torch.core import structure as struct
from repro_torch.core.config import AlphaFold2Config
from repro_torch.device import resolve_device
from repro_torch.nn.layers import (Dense, LayerNorm, Policy, cast_params, dense,
                                   layernorm)


# ---------------------------------------------------------------------------
# Input embedder (Algorithm 3) + recycling embedder (Algorithm 32)
# ---------------------------------------------------------------------------

class Embedder(nn.Module):
    def __init__(self, cfg: AlphaFold2Config, *, generator: torch.Generator):
        super().__init__()
        g = generator
        rel_dim = 2 * cfg.max_relative_idx + 1
        self.msa_proj = Dense(cfg.msa_feat_dim, cfg.c_m, generator=g)
        self.target_msa = Dense(cfg.target_feat_dim, cfg.c_m, generator=g)
        self.target_left = Dense(cfg.target_feat_dim, cfg.c_z, generator=g)
        self.target_right = Dense(cfg.target_feat_dim, cfg.c_z, generator=g)
        self.relpos = Dense(rel_dim, cfg.c_z, generator=g)
        self.extra_msa_proj = Dense(cfg.msa_feat_dim, cfg.extra.c_m, generator=g)
        self.rec_msa_ln = LayerNorm(cfg.c_m)
        self.rec_z_ln = LayerNorm(cfg.c_z)
        self.rec_dist = Dense(15, cfg.c_z, generator=g)
        self.single_proj = Dense(cfg.c_m, cfg.structure.c_s, generator=g)


class AlphaFold2(nn.Module):
    """All parameters, under the reference's key paths (``embedder.*``,
    ``extra_stack.<i>.*``, ``evoformer.<i>.*``, ``structure.*``, ``heads.*``).
    Initialised from ``seed`` (or a CPU ``generator``), fp32, then moved to
    ``device``: ``cuda`` by default, raising without a card unless
    ``device="cpu"`` is passed."""

    def __init__(self, cfg: AlphaFold2Config, *, seed: int = 0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(seed)
        self.embedder = Embedder(cfg, generator=g)
        self.extra_stack = nn.ModuleList(
            evo.EvoformerBlock(cfg.extra, generator=g)
            for _ in range(cfg.n_extra_msa_blocks))
        self.evoformer = nn.ModuleList(
            evo.EvoformerBlock(cfg.evoformer, generator=g)
            for _ in range(cfg.n_evoformer))
        self.structure = struct.StructureModule(cfg.structure, generator=g)
        self.heads = heads_lib.Heads(cfg, generator=g)
        self.to(device)


def embed_inputs(p: Embedder, cfg: AlphaFold2Config, batch: dict,
                 dtype=torch.bfloat16):
    """batch: msa_feat (s, r, f_m), target_feat (r, f_t), residue_index (r,),
    extra_msa_feat (se, r, f_m)."""
    tf = batch["target_feat"].to(dtype)
    msa = dense(p.msa_proj, batch["msa_feat"].to(dtype))
    msa = msa + dense(p.target_msa, tf)[None]
    z = dense(p.target_left, tf)[:, None] + dense(p.target_right, tf)[None, :]
    ri = batch["residue_index"].long()
    m = cfg.max_relative_idx
    rel = torch.clamp(ri[:, None] - ri[None, :], -m, m) + m
    z = z + dense(p.relpos, F.one_hot(rel, 2 * m + 1).to(dtype))
    extra = dense(p.extra_msa_proj, batch["extra_msa_feat"].to(dtype))
    return msa, z, extra


# float32 edges of the reference's jnp.linspace(3.375, 21.375, 14), bit for
# bit (torch.linspace rounds three of them one ulp apart, which would move
# a distance sitting on an edge into the next bin)
_RECYCLE_EDGES = tuple(float.fromhex(h) for h in (
    "0x1.b000000000000p+1", "0x1.309d8a0000000p+2", "0x1.893b140000000p+2",
    "0x1.e1d89e0000000p+2", "0x1.1d3b140000000p+3", "0x1.4989d80000000p+3",
    "0x1.75d89e0000000p+3", "0x1.a227640000000p+3", "0x1.ce76280000000p+3",
    "0x1.fac4ee0000000p+3", "0x1.1389da0000000p+4", "0x1.29b13c0000000p+4",
    "0x1.3fd89e0000000p+4", "0x1.5600000000000p+4"))


@functools.lru_cache(maxsize=None)
def recycle_edges(device: torch.device) -> torch.Tensor:
    """``_RECYCLE_EDGES`` on ``device``, made once: inside a captured CUDA
    graph a copy from host memory is not allowed."""
    return torch.tensor(_RECYCLE_EDGES, dtype=torch.float32, device=device)


def recycle_distance_bins(x: torch.Tensor) -> torch.Tensor:
    """CA coords (..., r, 3) -> binned distance map (..., r, r) int32: THE
    recycling discretization (15 bins), shared by the recycling embedder and
    ``predict``'s convergence test."""
    d = torch.sqrt((x[..., :, None, :] - x[..., None, :, :]).square().sum(-1)
                   + 1e-8)
    return (d[..., None] > recycle_edges(x.device)).sum(-1).to(torch.int32)


def embed_recycle(p: Embedder, cfg: AlphaFold2Config, msa, z, prev):
    """Add the recycled first MSA row, pair rep and binned CA distances."""
    prev_msa0, prev_z, prev_x = prev
    row0 = msa[0] + layernorm(p.rec_msa_ln, prev_msa0).to(msa.dtype)
    msa = torch.cat([row0[None], msa[1:]], 0)
    z = z + layernorm(p.rec_z_ln, prev_z).to(z.dtype)
    bins = F.one_hot(recycle_distance_bins(prev_x).long(), 15).to(z.dtype)
    return msa, z + dense(p.rec_dist, bins)


# ---------------------------------------------------------------------------
# Stacks and trunk
# ---------------------------------------------------------------------------

# the products whose outputs remat="dots" keeps: plain 2-D matmuls, the
# dense projections (``x @ w`` folds the leading axes into one), as
# ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` keeps the
# reference's dot_generals without batch dimensions
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def evoformer_stack(blocks: nn.ModuleList, cfg_block, msa, z, *,
                    masks: Optional[evo.EvoMasks] = None, rng=None,
                    deterministic: bool = True, remat=None, block_fn=None):
    """Apply the blocks in order (the reference scans over stacked params);
    block i draws its dropout from ``fold_in(rng, i)``.  ``remat`` (with
    autograd on): ``"block"`` keeps only each block's inputs and recomputes
    it in the backward (``torch.utils.checkpoint``, non-reentrant);
    ``"dots"`` keeps the outputs of its 2-D products (``aten.mm`` /
    ``aten.addmm``) as well and recomputes everything else, the hand-written
    kernels included.  Dropout masks are hashes of the block's rng, so the
    recompute draws the same masks.

    ``block_fn`` (a ``ParallelPlan``'s BP / DAP block; None: the serial
    ``evoformer_block``) takes the serial block's arguments.  A block_fn
    with ``prefetch_init`` (the overlapped DAP schedule) follows the
    prefetch protocol: the stack starts the gather of its input pair rep
    once (``prefetch_init``), hands each block the pending gather
    (``block_fn.block(..., prefetch=)``, which waits on it at its first
    use, so the block's work before that use runs in the gather's window),
    and after each block but the last starts the gather of the block's
    output (``prefetch_issue``), which the next block waits on.  Issues
    stay outside the checkpointed block; a recompute's wait returns the
    gathered tensor again without communicating.  A recompute that holds
    collectives (BP, DAP) reruns all of the block on every rank, so the
    ranks issue the same collectives in the same order."""
    fn = block_fn or evo.evoformer_block
    prefetch_init = getattr(fn, "prefetch_init", None)
    mask_kw = {} if masks is None else {"masks": masks}
    pending = prefetch_init(msa, z) if prefetch_init is not None else None
    ckpt = remat in ("block", "dots") and torch.is_grad_enabled()
    for i, blk in enumerate(blocks):
        def one(m, zz, blk=blk, key=evo.fold_in(rng, i), pending=pending):
            kw = dict(rng=key, deterministic=deterministic, **mask_kw)
            if pending is not None:
                mo, zo = fn.block(blk, cfg_block, m, zz, prefetch=pending,
                                  **kw)
            else:
                mo, zo = fn(blk, cfg_block, m, zz, **kw)
            return mo.to(m.dtype), zo.to(zz.dtype)
        if ckpt:
            # no block draws from torch's generators (dropout hashes its
            # rng), so there is no RNG state to stash and restore; stashing
            # it reads the CUDA generator's state, which a graph capture
            # does not allow
            kw = {"context_fn": _dots_contexts} if remat == "dots" else {}
            with set_checkpoint_early_stop(block_fn is None):
                msa, z = checkpoint(one, msa, z, use_reentrant=False,
                                    preserve_rng_state=False, **kw)
        else:
            msa, z = one(msa, z)
        if pending is not None and i + 1 < len(blocks):
            pending = fn.prefetch_issue(z)
    return msa, z


def remat_blocks(cfg: AlphaFold2Config) -> Optional[str]:
    """``cfg.remat`` as the stacks take it: None for 'none', else 'block'
    or 'dots'."""
    if cfg.remat not in ("none", "block", "dots"):
        raise ValueError(f"remat={cfg.remat!r}: the port has 'none', 'block' "
                         "and 'dots'")
    return None if cfg.remat == "none" else cfg.remat


def trunk_masks(batch) -> Optional[dict]:
    """Padded-bucket validity masks of an inference sample, or None when it
    carries no row mask (``res_mask`` alone does not trigger masking)."""
    if not any(k in batch for k in ("msa_row_mask", "extra_row_mask")):
        return None
    return {"res": batch.get("res_mask"),
            "msa_rows": batch.get("msa_row_mask"),
            "extra_rows": batch.get("extra_row_mask")}


def run_trunk(params: AlphaFold2, cfg: AlphaFold2Config, batch, prev, *,
              dtype=torch.bfloat16, masks: Optional[dict] = None, rng=None,
              deterministic: bool = True, remat=None, block_fn=None,
              stack_io=None):
    """One recycling iteration of the trunk: returns (msa, z, single).  The
    extra and main stacks draw dropout from sub-streams 1 and 2 of ``rng``.

    ``block_fn`` goes to both stacks; ``stack_io`` = (pre, post) wraps them
    (a ``ParallelPlan``'s): DAP shards (msa, z) at the entry of each stack
    and gathers at the exit, z staying sharded between the two stacks.
    Masked axes are read at full extent in every layout (DAP shards
    queries, never keys), so the same masks serve every block_fn."""
    msa, z, extra = embed_inputs(params.embedder, cfg, batch, dtype)
    msa, z = embed_recycle(params.embedder, cfg, msa, z, prev)
    pre, post = stack_io or ((lambda m, zz: (m, zz)),) * 2
    extra_masks = main_masks = None
    if masks is not None:
        ones = lambda n: torch.ones((n,), device=z.device)
        res = masks.get("res")
        res = ones(z.shape[0]) if res is None else res
        rows = masks.get("extra_rows")
        extra_masks = evo.EvoMasks(ones(extra.shape[0]) if rows is None else rows, res)
        rows = masks.get("msa_rows")
        main_masks = evo.EvoMasks(ones(msa.shape[0]) if rows is None else rows, res)
    kw = dict(deterministic=deterministic, remat=remat, block_fn=block_fn)
    extra_l, z_l = pre(extra, z)
    _, z_l = evoformer_stack(params.extra_stack, cfg.extra, extra_l, z_l,
                             masks=extra_masks, rng=evo.fold_in(rng, 1), **kw)
    msa_l = pre(msa, z)[0]
    msa_l, z_l = evoformer_stack(params.evoformer, cfg.evoformer, msa_l, z_l,
                                 masks=main_masks, rng=evo.fold_in(rng, 2),
                                 **kw)
    msa, z = post(msa_l, z_l)
    single = dense(params.embedder.single_proj, msa[0])
    return msa, z, single


# ---------------------------------------------------------------------------
# Training: forward with recycling, and the loss
# ---------------------------------------------------------------------------

def cycle_rng(rng, i: int):
    """Per-recycle-cycle dropout stream: sub-stream ``i`` of ``rng``, so no
    cycle reuses another's masks (the reference's ``fold_in`` of the cycle
    index)."""
    return evo.fold_in(rng, i)


def to_device(batch: dict, device) -> dict:
    """A sample's arrays (numpy or torch) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def forward(model: AlphaFold2, cfg: AlphaFold2Config, batch: dict, *,
            n_recycle: int = 1, rng=None, deterministic: bool = True,
            dtype=torch.bfloat16, block_fn=None, stack_io=None) -> dict:
    """Full forward of one protein with ``n_recycle`` trunk passes, the
    gradient through the last only.

    The fp32 master parameters are cast to ``dtype`` once, through autograd
    (:func:`cast_params`), so the gradients reach the masters.  The first
    ``n_recycle - 1`` cycles run under ``torch.no_grad`` (the kernels take
    their forward-only launches) and their recycled outputs are detached;
    the last cycle records the graph, with ``cfg.remat`` ("block" or
    "dots") checkpointing each Evoformer block.  Cycle i draws dropout from
    ``cycle_rng(rng, i)``.  ``block_fn`` / ``stack_io``: a plan's, to
    :func:`run_trunk`.
    """
    if n_recycle < 1:
        raise ValueError(f"n_recycle must be >= 1, got {n_recycle}")
    device = next(model.parameters()).device
    params = cast_params(model, dtype)
    batch = to_device(batch, device)
    r = batch["target_feat"].shape[0]
    prev = (torch.zeros((r, cfg.c_m), dtype=dtype, device=device),
            torch.zeros((r, r, cfg.c_z), dtype=dtype, device=device),
            torch.zeros((r, 3), device=device))
    remat = remat_blocks(cfg)

    def cycle(prev, key):
        msa, z, single = run_trunk(params, cfg, batch, prev, dtype=dtype,
                                   rng=key, deterministic=deterministic,
                                   remat=remat, block_fn=block_fn,
                                   stack_io=stack_io)
        (rots, trans), traj, s_final = struct.structure_module(
            params.structure, cfg.structure, single, z)
        out = {"msa": msa, "z": z, "single": single, "s_final": s_final,
               "rots": rots, "trans": trans, "traj": traj}
        return out, (msa[0], z, trans)

    with torch.no_grad():
        for i in range(n_recycle - 1):
            _, prev = cycle(prev, cycle_rng(rng, i))
    prev = tuple(t.detach() for t in prev)
    out, _ = cycle(prev, cycle_rng(rng, n_recycle - 1))
    return out


def loss_fn(model: AlphaFold2, cfg: AlphaFold2Config, batch: dict, *,
            n_recycle: int = 1, rng=None, deterministic: bool = True,
            dtype=torch.bfloat16, block_fn=None, stack_io=None) -> tuple:
    """(total, metrics) of one protein: 0.5 FAPE + 0.3 distogram + 2.0
    masked-MSA + 0.01 pLDDT.  The heads read the fp32 masters, as the
    reference's ``loss_fn`` does; mixed-type products promote to fp32."""
    out = forward(model, cfg, batch, n_recycle=n_recycle, rng=rng,
                  deterministic=deterministic, dtype=dtype, block_fn=block_fn,
                  stack_io=stack_io)
    batch = to_device(batch, out["z"].device)
    hp = model.heads
    res_mask = batch["res_mask"].float()
    rots_traj, trans_traj = out["traj"]
    l_fape = heads_lib.fape_loss(rots_traj, trans_traj, batch["true_rots"],
                                 batch["true_trans"], res_mask)
    l_dist = heads_lib.distogram_loss(
        heads_lib.distogram_logits(hp, out["z"]), batch["true_trans"],
        res_mask, n_bins=cfg.n_distogram_bins)
    l_msa = heads_lib.masked_msa_loss(
        heads_lib.masked_msa_logits(hp, out["msa"]), batch["true_msa"],
        batch["msa_mask_positions"].float())
    l_plddt = heads_lib.plddt_loss(
        heads_lib.plddt_logits(hp, out["s_final"]), out["trans"],
        batch["true_trans"], res_mask, n_bins=cfg.n_plddt_bins)
    total = 0.5 * l_fape + 0.3 * l_dist + 2.0 * l_msa + 0.01 * l_plddt
    metrics = {"loss": total, "fape": l_fape, "distogram": l_dist,
               "masked_msa": l_msa, "plddt": l_plddt}
    return total, metrics


# ---------------------------------------------------------------------------
# Inference: batched recycling with per-sample early exit
# ---------------------------------------------------------------------------

def fold_pair_mask(batch):
    """(pair_mask (B, r, r), pair_count (B,)): padded residues never vote on
    whether a sample converged."""
    bsz, r = batch["target_feat"].shape[:2]
    res_mask = batch.get("res_mask")
    dev = batch["target_feat"].device
    if res_mask is not None:
        pair_mask = (res_mask[:, :, None] * res_mask[:, None, :]).float()
    else:
        pair_mask = torch.ones((bsz, r, r), device=dev)
    return pair_mask, torch.clamp(pair_mask.sum((1, 2)), min=1.0)


def fold_carry_init(cfg: AlphaFold2Config, bsz: int, r: int, dtype, device):
    """Zero recycling carry: (prev (msa0, z, x), s_final)."""
    prev = (torch.zeros((bsz, r, cfg.c_m), dtype=dtype, device=device),
            torch.zeros((bsz, r, r, cfg.c_z), dtype=dtype, device=device),
            torch.zeros((bsz, r, 3), device=device))
    return prev, torch.zeros((bsz, r, cfg.structure.c_s), dtype=dtype,
                             device=device)


def sample_cycle(params: AlphaFold2, cfg: AlphaFold2Config, sample: dict,
                 prev: tuple, *, dtype=torch.bfloat16, block_fn=None,
                 stack_io=None) -> tuple:
    """One recycling cycle of one sample, a function of tensors only:
    ``sample`` its (padded) features, ``prev`` its carry (msa0, z, x).
    Returns (msa0, z, trans, s_final).  The unit a serving engine captures
    as a CUDA graph (``serve/fold_steps.py``); the eager path calls it too."""
    msa, z, single = run_trunk(params, cfg, sample, prev, dtype=dtype,
                               masks=trunk_masks(sample), block_fn=block_fn,
                               stack_io=stack_io)
    (_, trans), _, s_final = struct.structure_module(
        params.structure, cfg.structure, single, z, sample.get("res_mask"))
    return msa[0], z, trans, s_final


def fold_cycle(params: AlphaFold2, cfg: AlphaFold2Config, batch, prev, sf,
               conv, n_rec, *, tol: float, pair_mask, pair_count,
               dtype=torch.bfloat16, active=None, cycle=None, block_fn=None,
               stack_io=None):
    """ONE batched recycling cycle with per-sample freeze semantics.

    ``params`` is already cast to the compute dtype.  A converged sample, or
    an unoccupied micro-batch slot (``active`` False), keeps its carry and
    its recycle count; the reference computes it and throws the result
    away, this loop skips it, which gives the same carry.  ``cycle(params,
    sample, prev)`` runs one sample's cycle (:func:`sample_cycle` by
    default, with ``block_fn`` / ``stack_io``; a serving engine passes its
    captured graph of it).
    """
    keep = conv if active is None else (conv | ~active)
    new_prev = [t.clone() for t in prev]
    new_sf = sf.clone()
    for b, frozen in enumerate(keep.tolist()):
        if frozen:
            continue
        sample = {k: v[b] for k, v in batch.items()}
        prev_b = tuple(t[b] for t in prev)
        if cycle is None:
            out = sample_cycle(params, cfg, sample, prev_b, dtype=dtype,
                               block_fn=block_fn, stack_io=stack_io)
        else:
            out = cycle(params, sample, prev_b)
        for dst, src in zip((*new_prev, new_sf), out):
            dst[b] = src
    old_bins = recycle_distance_bins(prev[2])
    new_bins = recycle_distance_bins(new_prev[2])
    frac = ((old_bins != new_bins) * pair_mask).sum((1, 2)) / pair_count
    n_rec = n_rec + (~keep).to(n_rec.dtype)
    conv = conv | ((frac < tol) & ~keep)
    return tuple(new_prev), new_sf, conv, n_rec


def fold_heads(params: AlphaFold2, cfg: AlphaFold2Config, z, s_final) -> dict:
    """Confidence heads over a batched carry (params already cast)."""
    plddt_logits = heads_lib.plddt_logits(params.heads, s_final)
    disto_logits = heads_lib.distogram_logits(params.heads, z)
    return {
        "plddt": heads_lib.plddt_from_logits(plddt_logits),
        "contact_probs": heads_lib.contact_probs_from_distogram(disto_logits),
        "plddt_logits": plddt_logits,
        "distogram_logits": disto_logits,
    }


@torch.no_grad()
def predict(model: AlphaFold2, cfg: AlphaFold2Config, batch: dict, *,
            max_recycle: int, tol: float = 0.0, dtype=torch.bfloat16,
            active=None, cycle=None, block_fn=None, stack_io=None) -> dict:
    """Batched inference with adaptive early-exit recycling.

    ``batch``: per-sample features with a leading batch axis (B, ...) —
    msa_feat, extra_msa_feat, target_feat, residue_index, plus (padded
    buckets) res_mask / msa_row_mask / extra_row_mask.  Arrays are moved to
    the model's device.  A sample converges when fewer than ``tol`` of its
    valid residue pairs changed recycling bin in a cycle, and then freezes;
    the loop ends when all froze or ``max_recycle`` cycles ran.  ``tol=0``
    never converges.  ``active`` (B,) bool marks the occupied slots of a
    padded micro-batch: the others never run (``n_recycles`` 0).

    Returns coords (B, r, 3) fp32, plddt (B, r), contact_probs (B, r, r),
    the plddt / distogram logits, n_recycles (B,) and converged (B,).
    ``cycle``, ``block_fn`` and ``stack_io`` (an inference plan's) go to
    :func:`fold_cycle`.  A model already in ``dtype`` is
    used as it is, not copied (a captured ``cycle`` reads its storage).
    """
    if max_recycle < 1:
        raise ValueError(f"max_recycle must be >= 1, got {max_recycle}")
    device = next(model.parameters()).device
    params = Policy(compute_dtype=dtype).cast(model)   # fp32 -> compute, once
    batch = to_device(batch, device)
    bsz, r = batch["target_feat"].shape[:2]
    prev, sf = fold_carry_init(cfg, bsz, r, dtype, device)
    pair_mask, pair_count = fold_pair_mask(batch)
    conv = torch.zeros((bsz,), dtype=torch.bool, device=device)
    n_rec = torch.zeros((bsz,), dtype=torch.int32, device=device)
    if active is not None:
        active = torch.as_tensor(active, dtype=torch.bool, device=device)
    for _ in range(max_recycle):
        if bool((conv if active is None else conv | ~active).all()):
            break
        prev, sf, conv, n_rec = fold_cycle(
            params, cfg, batch, prev, sf, conv, n_rec, tol=tol,
            pair_mask=pair_mask, pair_count=pair_count, dtype=dtype,
            active=active, cycle=cycle, block_fn=block_fn, stack_io=stack_io)
    _, z, coords = prev
    out = fold_heads(params, cfg, z, sf)
    out.update(coords=coords, n_recycles=n_rec, converged=conv)
    return out
