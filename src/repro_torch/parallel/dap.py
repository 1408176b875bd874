"""Dynamic Axial Parallelism (FastFold; paper §3.2/§4.3) over rank
processes (counterpart of ``repro/parallel/dap.py``).

DAP shards the activations along one axial dimension over a ``dap`` mesh
axis — the MSA rep over its row axis s, the pair rep over its first residue
axis i — and re-shards with collectives wherever an op needs the other axis:

* row attention, transitions, triangle-start attention: local;
* column attention, triangle-end attention: an all-to-all transpose;
* triangle multiplications: an all-gather of the LayerNorm'd pair rep, the
  fused impl's operands oriented for the shard (the reference's fused
  route, ``dap.py:188-213``);
* attention biases from the pair rep: projected locally, heads gathered;
* outer-product mean: an all-to-all to residue shards and an all-gather of
  the right operand.

``msa_l`` is (s/d, r, c_m) and ``z_l`` (r/d, r, c_z).  Every function takes
the ``dap`` :class:`~repro_torch.parallel.mesh_utils.Axis` it runs over.

The port's fused triangle route has no ``tri_mult_supported`` fallback: the
kernels K3, K4 and K5 take any lengths, so they run on the shard's operands
as they are (``xa`` r/d rows, ``xb`` r rows).

Dropout draws the serial block's masks: each site keys its mask by the same
sub-stream as ``core.evoformer``, and every mask is shared along an axis
that DAP shards or transposes away, so a shard's mask is the serial mask.

The communication-overlapped schedule (``make_dap_block_fn(overlap=True)``,
FastFold's duplex idiom): both branches of the 'parallel' variant read the
block's input pair rep, so block k can start the gather of its output
(``z_full`` of block k+1) asynchronously, and block k+1 waits on it where
it first needs it: after its row attention's LayerNorm and q/k/v
projections, which the host issues inside the gather's window.
Consuming ``z_full`` replaces two gathers at the head of the block
(row-attention bias, triangle-out operand) by per-position math on the
gathered rep; the values are the same, as LayerNorm and the projections act
per position.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import evoformer as evo
from repro_torch.core.config import EvoformerConfig
from repro_torch.nn.layers import dense, layernorm
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.mesh_utils import Axis, local_slice


def _transpose_shards(x, axis: Axis):
    """(a/d, b, ...) -> (a, b/d, ...)."""
    return coll.all_to_all(x, axis, split_dim=1, concat_dim=0)


def _untranspose_shards(x, axis: Axis):
    """(a, b/d, ...) -> (a/d, b, ...)."""
    return coll.all_to_all(x, axis, split_dim=0, concat_dim=1)


# ---------------------------------------------------------------------------
# MSA branch under DAP
# ---------------------------------------------------------------------------

def dap_msa_branch(p: evo.EvoformerBlock, cfg: EvoformerConfig, msa_l, z_l, *,
                   axis: Axis, rng: evo.Rng = None, deterministic: bool = True,
                   masks=None, z_full=None):
    """``masks`` (padded-bucket inference): DAP shards query axes only, every
    masked key axis is consumed at full extent, so the full masks apply.
    ``z_full`` (overlap schedule): a zero-argument callable returning the
    gathered block-input pair rep, from which the row-attention bias is
    projected with no collective.  It is called once the row attention's
    LayerNorm and q/k/v projections are issued, so the host issues them
    inside the window of the gather it waits for."""
    impl = cfg.attention_impl
    rows_mask = res_mask = None
    if masks is not None:
        rows_mask, res_mask = masks.rows, masks.res
    h, q, k, v = evo.attention_qkv(p.row_attn, msa_l, n_head=cfg.n_head_msa,
                                   c_hidden=cfg.c_hidden_att)
    if z_full is not None:
        bias = evo.project_attention_bias(p.row_attn, z_full())    # (h, r, r)
    else:
        bias = coll.all_gather(evo.project_attention_bias(p.row_attn, z_l),
                               axis, dim=1)                        # (h, r, r)
    chunk = cfg.attention_chunk
    upd = evo.attend(p.row_attn, msa_l, h, q, k, v, bias=bias,
                     key_mask=res_mask, attention_impl=impl,
                     attention_chunk=chunk)
    msa_l = msa_l + evo.shared_dropout(
        upd, cfg.dropout_msa, shared_axis=0, rng=evo.fold_in(rng, 0),
        deterministic=deterministic)
    msa_r = _transpose_shards(msa_l, axis)                         # (s, r/d, c)
    cols = msa_r.transpose(0, 1)
    if cfg.global_column_attn:
        col = evo.global_attention(p.col_attn, cols, n_head=cfg.n_head_msa,
                                   c_hidden=cfg.c_hidden_att,
                                   key_mask=rows_mask)
    else:
        col = evo.gated_attention(p.col_attn, cols, n_head=cfg.n_head_msa,
                                  c_hidden=cfg.c_hidden_att,
                                  key_mask=rows_mask, attention_impl=impl,
                                  attention_chunk=chunk)
    msa_r = msa_r + col.transpose(0, 1)
    msa_l = _untranspose_shards(msa_r, axis)                       # (s/d, r, c)
    return msa_l + evo.transition(p.msa_trans, msa_l)


def dap_outer_product_mean(p: evo.OuterProductMean, msa_l, axis: Axis,
                           n_seq_total=None, *, row_chunk: int = 32,
                           opm_impl: str = "fused", row_mask=None):
    """OPM of an s-sharded MSA into an i-sharded pair update (r/d, r, c_z).

    ``n_seq_total``: the mean's denominator, the stack's total row count;
    None derives it from the shard (right for both stacks).  ``row_mask``
    (s,) zeroes padded rows once the operands are back at full s and makes
    the denominator the valid row count (``evo.mask_opm_operands``, the
    serial paths' rule).  ``opm_impl="fused"`` contracts in row chunks
    (``evo.opm_contract``); ``"naive"`` materialises this shard's (r/d, r,
    c²) outer product."""
    if opm_impl not in ("fused", "naive"):
        raise ValueError(f"unknown opm impl {opm_impl!r}")
    if n_seq_total is None:
        n_seq_total = msa_l.shape[0] * axis.size
    h = layernorm(p.ln, msa_l)
    a_i = _transpose_shards(dense(p.a, h), axis)                   # (s, r/d, c)
    b_full = coll.all_gather(_transpose_shards(dense(p.b, h), axis),
                             axis, dim=1)                          # (s, r, c)
    a_i, b_full, denom = evo.mask_opm_operands(a_i, b_full, row_mask,
                                               n_seq_total)
    if opm_impl == "naive":
        return evo.opm_project(
            p, torch.einsum("sic,sjd->ijcd", a_i, b_full) / denom,
            msa_l.dtype)
    return evo.opm_contract(a_i, b_full, p.out.w, p.out.b, denom,
                            msa_l.dtype, row_chunk=row_chunk)


# ---------------------------------------------------------------------------
# Pair branch under DAP
# ---------------------------------------------------------------------------

def dap_triangle_mult(p: evo.TriangleMult, z_l, *, outgoing: bool,
                      axis: Axis, impl: str = "pallas", chunk: int = 64,
                      k_mask=None, z_full=None):
    """Triangle update of an i-sharded pair rep ``z_l`` (r/d, r, c_z) on the
    fused impls (the reference's route for them, ``dap.py:188-213``):
    ``"pallas"`` (the kernels K3 / K4 / K5) or ``"chunked"`` (slabs of
    ``chunk``).  The LayerNorm'd pair rep is gathered, and the fused core
    gets the operands oriented for this shard — outgoing ``xa`` = the
    shard's rows, ``xb`` = every row; incoming the shard's columns and
    every column (sliced locally out of the gathered rep, no extra
    all-to-all).  ``k_mask`` (r,) drops padded residues from the
    k-contraction, which is full length in every orientation.  ``z_full``
    (overlap schedule, outgoing update of the block input only): the
    gathered pair rep, from which the operand is computed with no
    collective."""
    if impl not in ("chunked", "pallas"):
        raise ValueError(f"tri_mult_impl={impl!r}: DAP runs the fused "
                         "triangle impls ('chunked' or 'pallas')")
    x_l = layernorm(p.ln_in, z_l)                                  # (r/d, r, c)
    if z_full is not None:
        x_full = layernorm(p.ln_in, z_full)                        # (r, r, c)
    else:
        x_full = coll.all_gather(x_l, axis, dim=0)
    if outgoing:
        xa, xb = x_l, x_full           # out[i_l, j] = sum_k a(x[i_l,k]) b(x[j,k])
    else:                              # out[i_l, j] = sum_k a(x[k,i_l]) b(x[k,j])
        xa = local_slice(x_full, axis, 1).transpose(0, 1)
        xb = x_full.transpose(0, 1)
    return evo.triangle_mult_fused(p, xa, xb, x_l, impl=impl, chunk=chunk,
                                   out_dtype=z_l.dtype, k_mask=k_mask)


def dap_pair_branch(p: evo.EvoformerBlock, cfg: EvoformerConfig, z_l, *,
                    axis: Axis, rng: evo.Rng = None,
                    deterministic: bool = True, masks=None, z_full=None):
    """``z_full`` (overlap schedule): the gathered block-input pair rep,
    consumed by the outgoing triangle update (whose input it is under the
    'parallel' variant)."""
    impl = cfg.attention_impl
    res_mask = masks.res if masks is not None else None

    def drop(site, x, shared_axis):
        return evo.shared_dropout(x, cfg.dropout_pair, shared_axis=shared_axis,
                                  rng=evo.fold_in(rng, site),
                                  deterministic=deterministic)

    tri = dict(axis=axis, impl=cfg.tri_mult_impl, chunk=cfg.tri_mult_chunk,
               k_mask=res_mask)
    z_l = z_l + drop(0, dap_triangle_mult(p.tri_mul_out, z_l, outgoing=True,
                                          z_full=z_full, **tri), 0)
    z_l = z_l + drop(1, dap_triangle_mult(p.tri_mul_in, z_l, outgoing=False,
                                          **tri), 0)
    att = dict(n_head=cfg.n_head_pair, c_hidden=cfg.c_hidden_pair_att,
               key_mask=res_mask, attention_impl=impl,
               attention_chunk=cfg.attention_chunk)
    # starting node: rows local, bias heads gathered
    bias = coll.all_gather(evo.project_attention_bias(p.tri_att_start, z_l),
                           axis, dim=1)                            # (h, r, r)
    z_l = z_l + drop(2, evo.gated_attention(p.tri_att_start, z_l, bias=bias,
                                            **att), 0)
    # ending node: the bias projected from the shard before the transpose
    # (per position, so the same values), gathered and transposed
    bias_t = coll.all_gather(evo.project_attention_bias(p.tri_att_end, z_l),
                             axis, dim=1).transpose(1, 2)          # (h, j, i)
    zt_l = _transpose_shards(z_l, axis).transpose(0, 1)            # (r/d[j], r[i], c)
    zt_l = zt_l + drop(3, evo.gated_attention(p.tri_att_end, zt_l,
                                              bias=bias_t, **att), 0)
    z_l = _untranspose_shards(zt_l.transpose(0, 1), axis)
    return z_l + evo.transition(p.pair_trans, z_l)


# ---------------------------------------------------------------------------
# DAP Evoformer block (all three variants) and the stack adapters
# ---------------------------------------------------------------------------

def dap_evoformer_block(p: evo.EvoformerBlock, cfg: EvoformerConfig, msa_l,
                        z_l, *, axis: Axis, rng: evo.Rng = None,
                        deterministic: bool = True, n_seq_total=None,
                        masks=None):
    """The serial block's variants on DAP shards; the branches draw from
    sub-streams 0 and 1 of ``rng``, as the serial block's do."""
    row_mask = masks.rows if masks is not None else None
    kw = dict(axis=axis, deterministic=deterministic, masks=masks)
    rm, rz = evo.fold_in(rng, 0), evo.fold_in(rng, 1)

    def opm(m):
        return dap_outer_product_mean(p.opm, m, axis, n_seq_total,
                                      row_chunk=cfg.opm_chunk,
                                      opm_impl=cfg.opm_impl, row_mask=row_mask)

    if cfg.variant == "af2":
        msa_l = dap_msa_branch(p, cfg, msa_l, z_l, rng=rm, **kw)
        z_l = z_l + opm(msa_l)
        return msa_l, dap_pair_branch(p, cfg, z_l, rng=rz, **kw)
    if cfg.variant == "multimer":
        z_l = z_l + opm(msa_l)
        msa_l = dap_msa_branch(p, cfg, msa_l, z_l, rng=rm, **kw)
        return msa_l, dap_pair_branch(p, cfg, z_l, rng=rz, **kw)
    if cfg.variant == "parallel":
        msa_out = dap_msa_branch(p, cfg, msa_l, z_l, rng=rm, **kw)
        z_out = dap_pair_branch(p, cfg, z_l, rng=rz, **kw)
        return msa_out, z_out + opm(msa_out)
    raise ValueError(f"unknown Evoformer variant {cfg.variant!r}")


def dap_evoformer_block_overlap(p: evo.EvoformerBlock, cfg: EvoformerConfig,
                                msa_l, z_l, z_full, *, axis: Axis,
                                rng: evo.Rng = None,
                                deterministic: bool = True, n_seq_total=None,
                                masks=None):
    """The consume half of the overlapped 'parallel' block: ``z_full`` (the
    gathered block input: a ``collectives.Pending`` started by the previous
    block, waited on at its first use, or the gathered tensor) feeds the
    row-attention bias and the outgoing triangle operand; returns
    (msa_out, z_out).  Only the 'parallel' variant qualifies: its two
    branches both read the block-input pair rep."""
    if cfg.variant != "parallel":
        raise ValueError(
            f"the overlapped DAP schedule requires the 'parallel' Evoformer "
            f"variant (both branches consume the block-input pair rep); got "
            f"variant={cfg.variant!r} — use overlap_dap=False or "
            "variant='parallel'")
    row_mask = masks.rows if masks is not None else None
    got = []

    def full():
        if not got:
            got.append(z_full.wait() if isinstance(z_full, coll.Pending)
                       else z_full)
        return got[0]

    kw = dict(axis=axis, deterministic=deterministic, masks=masks)
    msa_out = dap_msa_branch(p, cfg, msa_l, z_l, rng=evo.fold_in(rng, 0),
                             z_full=full, **kw)
    z_out = dap_pair_branch(p, cfg, z_l, rng=evo.fold_in(rng, 1),
                            z_full=full(), **kw)
    return msa_out, z_out + dap_outer_product_mean(
        p.opm, msa_out, axis, n_seq_total, row_chunk=cfg.opm_chunk,
        opm_impl=cfg.opm_impl, row_mask=row_mask)


def shard_inputs(msa, z, axis: Axis):
    """This rank's DAP shards of full (replicated) reps."""
    return local_slice(msa, axis, 0), local_slice(z, axis, 0)


def unshard_outputs(msa_l, z_l, axis: Axis):
    return coll.all_gather(msa_l, axis, 0), coll.all_gather(z_l, axis, 0)


class OverlapBlockFn:
    """The ``block_fn`` of the overlapped schedule, following the stack's
    prefetch protocol: the stack starts the gather of its input pair rep
    with :meth:`prefetch_init`, then for each block runs :meth:`block` on
    the pending gather (the consume half, which waits on it at its first
    use in block k+1) and starts the gather of the block's output with
    :meth:`prefetch_issue` (the issue half, at the end of block k).  A call
    runs both halves of one block and returns (msa, z, pending), the
    reference's block signature."""

    def __init__(self, axis: Axis, n_seq_total=None):
        self.axis, self.n_seq_total = axis, n_seq_total

    def block(self, p, cfg, msa_l, z_l, *, prefetch, rng=None,
              deterministic=True, masks=None):
        return dap_evoformer_block_overlap(
            p, cfg, msa_l, z_l, prefetch, axis=self.axis, rng=rng,
            deterministic=deterministic, n_seq_total=self.n_seq_total,
            masks=masks)

    def __call__(self, p, cfg, msa_l, z_l, *, prefetch, rng=None,
                 deterministic=True, masks=None):
        m, z = self.block(p, cfg, msa_l, z_l, prefetch=prefetch, rng=rng,
                          deterministic=deterministic, masks=masks)
        return m, z, self.prefetch_issue(z)

    def prefetch_init(self, msa_l, z_l) -> coll.Pending:
        return self.prefetch_issue(z_l)

    def prefetch_issue(self, z_l) -> coll.Pending:
        return coll.all_gather_start(z_l, self.axis, 0)


def make_dap_block_fn(axis: Axis, n_seq_total=None, overlap: bool = False):
    """The DAP ``block_fn`` over ``axis`` (``evoformer_stack``'s signature);
    with ``overlap=True`` an :class:`OverlapBlockFn`, whose
    ``prefetch_init`` makes the stack drive the prefetch protocol."""
    if overlap:
        return OverlapBlockFn(axis, n_seq_total)
    return functools.partial(dap_evoformer_block, axis=axis,
                             n_seq_total=n_seq_total)
