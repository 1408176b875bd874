"""Tensor parallelism over the ``model`` mesh axis: what the reference's
GSPMD program computes from the LM families' partition rules (Megatron's
layout; ``repro/models/*.py`` ``partition_rules``), written out as one
rank's program.

A rank holds the slice of every parameter that its sanitized spec names
(``train.trainstep.sanitize_spec``; ``parallel.fsdp.Layout`` cuts it), and
the families' forward functions read their local widths off the slices.
Within :func:`model_parallel` (a module global, as ``fsdp.data_parallel``:
the autograd engine's threads read it) the helpers here run the
collectives; outside it, or over an axis of extent 1, they are the
identity, so the one-device path is unchanged.

* Column-parallel layers (``w[qkv]``, ``mlp/w_(gate|up)``, ``wz`` / ``wx``
  / ``wdt``, ``w_in``, the shared experts' up / gate) read their input
  through :func:`copy_in` (``collectives.copy_to``: the identity forward,
  an all-reduce of the input's cotangent backward).
* Row-parallel layers (``wo``, ``w_down``, ``out``, ``[wx]o``,
  ``w_out``) end in :func:`reduce_out` (``collectives.reduce_from``: an
  all-reduce forward, the identity backward), then add a replicated bias
  once (:func:`row_dense`; whisper's ``[wx]o/b`` and ``mlp/w_out/b``).
  Conjugate pairs, not ``psum``: a row-parallel output is replicated, so
  its cotangent is too, and ``psum``'s backward all-reduce would multiply
  every gradient by the axis's extent (``test_torch_lm_tp.py`` pins it).
* A replicated value that a rank uses only in part (the MoE gates, the
  SSM's B and C, a replicated parameter of which a rank reads its
  columns) goes through :func:`copy_in` at the point of that use, so every
  replicated leaf's gradient is whole and the same on every rank: the step
  sums no gradient over ``model``.
* Vocab-parallel: :func:`embed` (a masked lookup, then ``reduce_out``),
  :func:`cross_entropy` (a pmax of the max, one all-reduce of the sums of
  exponentials and of the target logits), :func:`greedy` (an argmax over
  the split with the lowest index among ties) and :func:`full_vocab`.
  A vocabulary ``model`` does not divide stays replicated, and so do its
  logits.
* Two column-parallel layers in a row (the vlm ``projector/w1`` -> ``w2``,
  the hybrid ``shared/fuse`` -> ``shared/w[qkv]``) gather the first
  one's output with :func:`gather` (an all-gather whose backward takes this
  rank's slice) before the second.

Attention heads (:class:`Heads`).  ``sanitize_spec`` keeps ``model`` on a
projection wherever it divides the columns, not the heads.  Where the
split falls on head boundaries, and each rank's query heads use only its
own KV heads, attention is local.  Where it does not, the rank gathers the
projection's output over ``model`` (``collectives.all_gather``: a
reduce-scatter backward, since each rank uses a part) and computes the
heads whose columns meet its rows of ``wo``; of their output it keeps the
columns of those rows.  This is what GSPMD's resharding computes.  The
ten configs at ``model`` 2 / 4 / 16 (query heads, KV heads):

==================== ============== ============== =====================
config               model 2        model 4        model 16
==================== ============== ============== =====================
glm4-9b 32 / 2       local          KV gathered    KV gathered
qwen1.5-110b 64 / 8  local          local          KV gathered
deepseek-67b 64 / 8  local          local          KV gathered
deepseek-coder 56/8  local          local          Q and KV gathered
qwen2-moe 16 / 16    local          local          local
phi3.5-moe 32 / 8    local          local          KV gathered
zamba2-7b 32 / 32    local          local          local
whisper 16 / 16      local          local          local
internvl2 48 / 8     local          local          KV gathered
mamba2-2.7b          no attention; 80 SSM heads split 40 / 20 / 5
==================== ============== ============== =====================

(deepseek-coder's 56 heads at 16: 448 columns, 3.5 heads a rank.)  The
smoke configs (4 / 2 heads) are local at 2 and gather KV at 4.

A KV cache holds the heads its cache rule names (``serve.steps
.cache_partition_rules``: on ``model`` only where 16 divides the KV
heads, else replicated).  A replicated cache beside split ``wk`` / ``wv``
takes every KV head, so the step gathers the k / v projections before the
write (:meth:`Heads.kv_full`), and attention reads its heads from it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch.parallel import collectives as coll
from repro_torch.parallel.mesh_utils import Axis

_AXIS: list = []


@contextlib.contextmanager
def model_parallel(axis: Optional[Axis]):
    """Within: the parameters are this rank's slices over ``axis`` (None,
    or extent 1: whole), and the helpers here run its collectives.  The
    backward belongs inside too (a remat recompute runs the forward
    again)."""
    _AXIS.append(axis)
    try:
        yield axis
    finally:
        _AXIS.pop()


def current() -> Optional[Axis]:
    """The innermost :func:`model_parallel` axis of extent > 1, or None."""
    axis = _AXIS[-1] if _AXIS else None
    return axis if axis is not None and axis.size > 1 else None


def copy_in(x):
    """``collectives.copy_to`` over the current axis (identity outside)."""
    axis = current()
    return x if axis is None else coll.copy_to(x, axis)


def reduce_out(x):
    """``collectives.reduce_from`` over the current axis."""
    axis = current()
    return x if axis is None else coll.reduce_from(x, axis)


def gather(x, dim: int = -1):
    """Every rank's ``x`` along ``dim``, used whole
    (``collectives.all_gather_rep``)."""
    axis = current()
    return x if axis is None else coll.all_gather_rep(x, axis,
                                                      dim % x.dim())


def gather_part(x, dim: int = -1):
    """Every rank's ``x`` along ``dim``, of which each rank uses a part
    (``collectives.all_gather``: the backward sums the cotangents)."""
    axis = current()
    return x if axis is None else coll.all_gather(x, axis, dim % x.dim())


def split_of(local: int, full: int, what: str = "") -> Optional[tuple]:
    """(lo, hi): this rank's range of a dim of extent ``full`` that it holds
    ``local`` of; None where it holds the whole.  Raises where ``local`` is
    neither (a layout this module cannot compute)."""
    axis = current()
    if axis is None or local == full:
        return None
    if local * axis.size != full:
        raise ValueError(f"{what}: {local} of {full} is neither whole nor "
                         f"a 1/{axis.size} slice over 'model'")
    return axis.index * local, (axis.index + 1) * local


def narrow(t, dim: int, rng: Optional[tuple]):
    """``t``'s ``rng`` = (lo, hi) along ``dim`` (all of it for None)."""
    return t if rng is None else t.narrow(dim, rng[0], rng[1] - rng[0])


def row_dense(p, x, full_in: int, what: str = ""):
    """A row-parallel ``dense``: ``x`` (this rank's columns, when ``p.w``
    holds this rank's rows of ``full_in``) times ``p.w``, summed over the
    axis, then ``p.b`` (replicated) added once."""
    w = p.w
    split = split_of(w.shape[0], full_in, what)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = x @ w
    if split is not None:
        y = reduce_out(y)
    if p.b is not None:
        y = y + p.b
    return y


# ---------------------------------------------------------------------------
# attention heads
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Heads:
    """How this rank computes an attention block whose projections it holds
    at ``q_cols`` / ``kv_cols`` columns (see the module docstring).
    ``split``: ``wo``'s rows are split (else every rank computes every head
    whole and nothing is reduced).  Heads ``[h_lo, h_hi)`` are computed,
    from KV heads ``[kv_lo, kv_hi)``; of their flattened output the columns
    ``[c_lo, c_hi)`` meet this rank's rows of ``wo``."""
    n_head: int
    n_kv: int
    d: int
    split: bool = False
    q_gather: bool = False
    kv_gather: bool = False
    kv_local: tuple = None      # this rank's KV heads when they are whole
    h_lo: int = 0
    h_hi: int = 0
    kv_lo: int = 0
    kv_hi: int = 0
    c_lo: int = 0
    c_hi: int = 0
    expand: tuple = None        # KV index of each head (a non-uniform GQA)

    @property
    def group(self) -> int:
        return self.n_head // self.n_kv

    def copy_in(self, h):
        return copy_in(h) if self.split else h

    def q(self, proj):
        """The computed heads' queries (..., nh, d) of the q projection's
        output (..., q_cols)."""
        if self.q_gather:
            proj = gather_part(proj)
        if self.q_gather or not self.split:
            proj = proj[..., self.h_lo * self.d:self.h_hi * self.d]
        return proj.reshape(*proj.shape[:-1], self.h_hi - self.h_lo, self.d)

    def _select(self, kv):
        """(..., KV heads from kv_lo) -> the computed heads' KV, expanded
        to one a query head where the groups are not uniform."""
        kv = kv[..., :self.kv_hi - self.kv_lo, :]
        if self.expand is not None:
            kv = kv[..., list(self.expand), :]
        return kv

    def kv(self, proj):
        """The KV heads the computed heads read (..., nkv, d), from a k / v
        projection's output (..., kv_cols)."""
        if self.kv_gather:
            proj = gather_part(proj)
        kv = proj.reshape(*proj.shape[:-1], -1, self.d)
        if self.kv_gather or not self.split:
            kv = kv[..., self.kv_lo:, :]
        return self._select(kv)

    def kv_full(self, proj):
        """Every KV head (..., n_kv, d) of a k / v projection's output, for
        a replicated cache: gathered where the projection is split (no
        gradient: serving only)."""
        if self.split:
            with torch.no_grad():
                proj = coll.all_gather(proj, current(), proj.dim() - 1)
        return proj.reshape(*proj.shape[:-1], self.n_kv, self.d)

    def cache_is_local(self, c) -> bool:
        """Whether a cache (..., KVc, d) holds this rank's KV heads only
        (else all of them); raises where the heads it holds are not the
        ones this rank's queries read."""
        if c.shape[-2] == self.n_kv:
            return False
        if self.kv_local is None or c.shape[-2] != (self.kv_local[1]
                                                    - self.kv_local[0]):
            raise ValueError(f"a cache of {c.shape[-2]} KV heads a rank "
                             f"does not match this rank's heads {self}")
        return True

    def from_cache(self, c):
        """The KV heads the computed heads read, from a cache (..., KVc,
        d) that holds this rank's KV heads or all of them."""
        if self.cache_is_local(c):
            return c
        return self._select(c[..., self.kv_lo:, :])

    def for_cache(self, proj, c):
        """What a cache ``c`` takes of a k / v projection's output: this
        rank's KV heads, or every one (:meth:`kv_full`)."""
        if self.cache_is_local(c):
            return proj.reshape(*proj.shape[:-1], -1, self.d)
        return self.kv_full(proj)

    def out(self, o, wo, what: str = "wo"):
        """``wo`` of the computed heads' output ``o`` (..., nh, d): the
        columns of this rank's rows, the row-parallel product, summed; the
        bias (if any) once."""
        o = o.reshape(*o.shape[:-2], -1)
        if self.split and (self.c_lo, self.c_hi) != (0, o.shape[-1]):
            o = o[..., self.c_lo:self.c_hi]
        return row_dense(wo, o, self.n_head * self.d, what)


def heads(n_head: int, n_kv: int, d: int, q_cols: int, kv_cols: int,
          what: str = "") -> Heads:
    """The :class:`Heads` plan of a block whose q / k projections this rank
    holds at ``q_cols`` / ``kv_cols`` columns."""
    axis = current()
    full_q, full_kv = n_head * d, n_kv * d
    if axis is None or q_cols == full_q:
        if kv_cols != full_kv:
            raise ValueError(f"{what}: k / v split over 'model' beside a "
                             "whole q projection")
        return Heads(n_head, n_kv, d, h_hi=n_head, kv_hi=n_kv,
                     kv_local=(0, n_kv), c_hi=full_q)
    m, r = axis.size, axis.index
    if q_cols * m != full_q:
        raise ValueError(f"{what}/wq: {q_cols} of {full_q} columns")
    if kv_cols * m != full_kv:
        raise ValueError(f"{what}/wk: {kv_cols} of {full_kv} columns beside "
                         "a split wq (a replicated k / v projection a rank "
                         "reads in part is not computed here)")
    g = n_head // n_kv
    lo, hi = r * q_cols, (r + 1) * q_cols
    h_lo, h_hi = lo // d, -(-hi // d)
    kv_lo, kv_hi = h_lo // g, (h_hi - 1) // g + 1
    own = None
    if kv_cols % d == 0:
        own = (r * kv_cols // d, (r + 1) * kv_cols // d)
    kv_gather = own != (kv_lo, kv_hi)
    expand = None
    if kv_hi - kv_lo > 1 and (h_lo % g or h_hi % g):
        expand = tuple(h // g - kv_lo for h in range(h_lo, h_hi))
    return Heads(n_head, n_kv, d, split=True, q_gather=q_cols % d != 0,
                 kv_gather=kv_gather, kv_local=None if kv_gather else own,
                 h_lo=h_lo, h_hi=h_hi, kv_lo=kv_lo, kv_hi=kv_hi,
                 c_lo=lo - h_lo * d, c_hi=hi - h_lo * d, expand=expand)


def block_heads(p, n_head: int, n_kv: int, d: int, prefix: str = "w",
                what: str = "") -> Heads:
    """:func:`heads` of the block ``p`` holding ``<prefix>q`` /
    ``<prefix>k``."""
    return heads(n_head, n_kv, d, getattr(p, prefix + "q").w.shape[-1],
                 getattr(p, prefix + "k").w.shape[-1], what)


# ---------------------------------------------------------------------------
# vocab-parallel embedding, logits, cross entropy, argmax
# ---------------------------------------------------------------------------

def _vocab_split(n: int, vocab: int):
    return split_of(n, vocab, "vocab")


def embed(table, tokens, vocab: int):
    """``table[tokens]`` where ``table`` holds this rank's rows of the
    vocabulary: the rows it holds looked up, the others zero, summed over
    the axis."""
    split = _vocab_split(table.shape[0], vocab)
    if split is None:
        return table[tokens.long()]
    lo, hi = split
    local = tokens.long() - lo
    hit = (local >= 0) & (local < hi - lo)
    x = table[local.clamp(0, hi - lo - 1)] * hit[..., None].to(table.dtype)
    return reduce_out(x)


def cross_entropy(logits, labels, vocab: int, *, mask=None):
    """``models.dense.cross_entropy`` of logits split over the vocabulary:
    a pmax of the rows' max (no gradient), then one all-reduce of the sums
    of exponentials and the target logits (the identity backward: the loss
    is the same on every rank)."""
    split = _vocab_split(logits.shape[-1], vocab)
    if split is None:
        from repro_torch.models.dense import cross_entropy as ce
        return ce(logits, labels, mask=mask)
    lo, hi = split
    lf = logits.float()
    with torch.no_grad():
        m = coll.pmax(lf.max(-1).values, current())
    se = torch.exp(lf - m[..., None]).sum(-1)
    local = labels.long() - lo
    hit = (local >= 0) & (local < hi - lo)
    tgt = logits.gather(-1, local.clamp(0, hi - lo - 1)[..., None])[..., 0]
    tgt = tgt.float() * hit
    se, tgt = reduce_out(torch.stack([se, tgt])).unbind(0)
    nll = torch.log(se) + m - tgt
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


@torch.no_grad()
def greedy(logits, vocab: int):
    """argmax over the last dim of logits split over the vocabulary (or
    whole): the lowest index among equal maxima, as ``jnp.argmax``."""
    idx = torch.argmax(logits, dim=-1)
    split = _vocab_split(logits.shape[-1], vocab)
    if split is None:
        return idx
    axis = current()
    best = logits.gather(-1, idx[..., None])[..., 0].float()
    top = coll.pmax(best, axis)
    cand = torch.where(best == top, idx + split[0],
                       torch.full_like(idx, vocab))
    return -coll.pmax(-cand, axis)


@torch.no_grad()
def full_vocab(logits, vocab: int):
    """Logits over the whole vocabulary (gathered where split)."""
    if _vocab_split(logits.shape[-1], vocab) is None:
        return logits
    return coll.all_gather(logits.contiguous(), current(), logits.dim() - 1)


def lm_logits(x, w, vocab: int, *, tied: bool = False):
    """Logits of ``x`` through the head ``w`` (D, V) or, ``tied``, the
    embedding table (V, D): vocab-parallel where ``w`` holds a slice."""
    n = w.shape[0] if tied else w.shape[-1]
    if _vocab_split(n, vocab) is not None:
        x = copy_in(x)
    if tied:
        return x @ w.to(x.dtype).T
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)
