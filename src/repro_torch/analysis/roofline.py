"""Per-block roofline costs of the AF2 Evoformer under (BP, DAP) splits —
the part of ``repro/analysis/roofline.py:8-304`` that
``parallel.plan.auto_plan`` needs, with H100 constants.

The cost model is the reference's: FLOP and byte counts of one
main-Evoformer block per device, composed with a tile-efficiency term for
DAP's sharded axes, a latency term per collective, and BP's concurrency of
the two branches.  Only the hardware differs: :class:`HW` defaults to the
H100 SXM (700 W) datasheet figures, and its two model parameters are
labelled as assumptions.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HW:
    # NVIDIA H100 SXM5 datasheet (700 W): dense bf16 tensor-core FLOP/s,
    # HBM3 bytes/s, and NVLink 4 bytes/s per direction per card (18 links,
    # 900 GB/s both directions together)
    peak_flops: float = 989e12
    hbm_bw: float = 3.35e12
    link_bw: float = 450e9
    # model assumptions, not measured: the dispatch and synchronisation cost
    # of one collective (DAP issues ~13 per block against BP's one), and the
    # rows below which a sharded GEMM runs short of full tiles (one 128-row
    # tile of a Hopper tensor-core GEMM)
    coll_launch: float = 10e-6
    tile_rows: float = 128.0
    # share of DAP's collective time the overlapped schedule hides behind
    # compute: 1.0 the ideal max(compute, comm), 0.0 the sync sum
    overlap_eff: float = 0.5


def tri_mult_flops(cfg) -> float:
    """Forward FLOPs of one block's two triangle-multiplicative updates:
    the gated a/b projections and the output gate, the r-contraction, the
    output projection."""
    e = cfg.evoformer
    r, z, c_mul = cfg.n_res, e.c_z, e.c_hidden_mul
    return 2 * (2 * r * r * z * c_mul * 3 + 2 * r ** 3 * c_mul +
                2 * r * r * c_mul * z)


def tri_mult_hbm_bytes(cfg, impl: str = None, *, dap: int = 1,
                       elt: int = 2) -> float:
    """Forward HBM bytes per device of one block's two triangle updates, by
    ``tri_mult_impl`` (None: the config's); the reference's coarse
    activation-traffic counts over ``area`` = this device's (r/dap)·r output
    positions: ``reference`` round-trips its projections and gated pair,
    ``chunked`` re-reads an fp32 accumulator per k-chunk, the fused kernel
    (``pallas``) touches its input, gate source and output, with the xb
    operand read once per 128-row block of i."""
    e = cfg.evoformer
    impl = impl or e.tri_mult_impl
    r, z, c_mul = cfg.n_res, e.c_z, e.c_hidden_mul
    area = (r // max(dap, 1)) * r
    if impl == "reference":
        per_op = elt * area * (8 * z + 6 * c_mul)
    elif impl == "chunked":
        n_k = -(-r // max(1, e.tri_mult_chunk))
        per_op = elt * area * 6 * z + 4 * area * c_mul * 2 * n_k
    elif impl == "pallas":
        n_i = -(-r // min(r, 128))
        per_op = elt * area * z * (3 + n_i)
    else:
        raise ValueError(f"unknown tri_mult impl {impl!r}")
    return 2.0 * per_op


def evo_branch_flops(cfg) -> tuple:
    """(MSA branch + OPM, pair branch) forward FLOPs of one main-Evoformer
    block: the parallel variant's two dependency-free branches, whose
    balance ``max / sum`` bounds BP's speed-up (paper §4.2)."""
    e = cfg.evoformer
    s, r, m, z = cfg.n_seq, cfg.n_res, e.c_m, e.c_z
    ha = e.n_head_msa * e.c_hidden_att
    row = 2 * s * r * m * ha * 4 + 2 * s * r * r * ha * 2
    col = 2 * s * r * m * ha * 4 + 2 * r * s * s * ha * 2
    mtrans = 2 * s * r * m * 4 * m * 2
    opm = (2 * s * r * m * e.c_hidden_opm * 2 +
           2 * r * r * s * e.c_hidden_opm ** 2 +
           2 * r * r * e.c_hidden_opm ** 2 * z)
    hp = e.n_head_pair * e.c_hidden_pair_att
    tri_att = 2 * (2 * r * r * z * hp * 4 + 2 * r ** 3 * hp * 2)
    ptrans = 2 * r * r * z * 4 * z * 2
    return row + col + mtrans + opm, tri_mult_flops(cfg) + tri_att + ptrans


def dap_comm_bytes(cfg, dap: int, *, elt: int = 2,
                   overlap: bool = False) -> tuple:
    """(MSA branch, pair branch) forward collective bytes per device of one
    block at DAP extent ``dap``, the ``parallel.dap`` schedule: a tiled
    all-gather receives (d-1)/d of the full tensor, an all-to-all moves
    (d-1)/d of a 1/d shard.  ``overlap`` prices the overlapped schedule:
    the row-bias and triangle-out gathers give way to one gather of the
    (r, r, c_z) block output."""
    if dap <= 1:
        return 0.0, 0.0
    e = cfg.evoformer
    s, r, d = cfg.n_seq, cfg.n_res, dap
    gather = (d - 1) / d
    a2a = (d - 1) / (d * d)
    bias_gather = 0.0 if overlap else e.n_head_msa * r * r * gather
    msa = (bias_gather
           + 2 * s * r * e.c_m * a2a
           + s * r * e.c_hidden_opm * a2a
           + s * r * e.c_hidden_opm * (a2a + gather)) * elt
    tri_gathers = ((r * r * e.c_hidden_mul + r * r * e.c_z) if overlap
                   else 2 * r * r * e.c_hidden_mul) * gather
    pair = (tri_gathers
            + r * r * e.c_hidden_mul * a2a
            + 2 * e.n_head_pair * r * r * gather
            + 2 * r * r * e.c_z * a2a) * elt
    return msa, pair


# DAP collectives per block forward (the parallel.dap schedule), by branch;
# the overlapped schedule drops the row-bias gather and swaps the
# triangle-out gather for the prefetch
N_DAP_COLLECTIVES_MSA = 6
N_DAP_COLLECTIVES_PAIR = 7
N_DAP_COLLECTIVES_MSA_OVERLAP = 5
N_DAP_COLLECTIVES_PAIR_OVERLAP = 7


def bp_exchange_bytes(cfg, dap: int = 1, *, elt: int = 2) -> float:
    """Forward bytes per device of BP's one block-end all-reduce: msa_out
    (s, r, c_m) and the OPM and pair terms (2 x (r, r, c_z)), DAP-sharded
    under the hybrid; a 2-rank all-reduce moves 2(n-1)/n = 1x the payload."""
    e = cfg.evoformer
    payload = (cfg.n_seq * cfg.n_res * e.c_m +
               2 * cfg.n_res * cfg.n_res * e.c_z) / max(dap, 1)
    return payload * elt


def estimate_block_time(cfg, *, bp: int = 1, dap: int = 1, hw: HW = HW(),
                        fwd_bwd: bool = True, elt: int = 2,
                        overlap: bool = None) -> float:
    """Roofline seconds of one main-Evoformer block per device under a
    (BP, DAP) split: DAP divides each branch's FLOPs by ``dap`` but loses
    tile efficiency once the sharded axis drops below ``hw.tile_rows``; DAP
    pays its collectives (bytes over ``hw.link_bw`` plus ``hw.coll_launch``
    each), BP one all-reduce; BP=2 runs the branches concurrently (the max).
    The pair branch also carries the triangle updates' HBM time.
    ``overlap`` (None: on for a pure-DAP 'parallel' split) composes compute
    and communication as ``eff * max + (1 - eff) * sum``.  ``fwd_bwd``
    scales compute x3 and communication x2."""
    if overlap is None:
        overlap = (dap > 1 and bp == 1
                   and cfg.evoformer.variant == "parallel")
    f_msa, f_pair = evo_branch_flops(cfg)
    d = max(dap, 1)
    eff_msa = min(1.0, (cfg.n_seq / d) / hw.tile_rows)
    eff_pair = min(1.0, (cfg.n_res / d) / hw.tile_rows)
    t_msa = f_msa / d / (hw.peak_flops * eff_msa)
    t_pair = max(f_pair / d / (hw.peak_flops * eff_pair),
                 tri_mult_hbm_bytes(cfg, dap=d, elt=elt) / hw.hbm_bw)
    b_msa, b_pair = dap_comm_bytes(cfg, d, elt=elt, overlap=overlap)
    kc, kb = (3.0, 2.0) if fwd_bwd else (1.0, 1.0)
    n_msa = (N_DAP_COLLECTIVES_MSA_OVERLAP if overlap
             else N_DAP_COLLECTIVES_MSA)
    n_pair = (N_DAP_COLLECTIVES_PAIR_OVERLAP if overlap
              else N_DAP_COLLECTIVES_PAIR)
    c_msa = b_msa / hw.link_bw + (n_msa * hw.coll_launch if d > 1 else 0.0)
    c_pair = b_pair / hw.link_bw + (n_pair * hw.coll_launch if d > 1 else 0.0)
    if bp > 1:
        return max(kc * t_msa + kb * c_msa, kc * t_pair + kb * c_pair) + \
            kb * (bp_exchange_bytes(cfg, d, elt=elt) / hw.link_bw +
                  hw.coll_launch)
    if overlap and d > 1:
        comp = kc * (t_msa + t_pair)
        comm = kb * (c_msa + c_pair)
        return hw.overlap_eff * max(comp, comm) + \
            (1.0 - hw.overlap_eff) * (comp + comm)
    return kc * (t_msa + t_pair) + kb * (c_msa + c_pair)
