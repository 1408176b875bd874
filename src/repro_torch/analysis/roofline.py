"""Roofline costs with H100 constants (counterpart of
``repro/analysis/roofline.py``): the roofline terms of a step, model FLOPs
and active parameters of the LM configs, the per-block costs of the AF2
Evoformer under (BP, DAP) splits that ``parallel.plan.auto_plan`` ranks
plans with, and their extension to a whole training step
(``predict_step_time``) that ``obs.attribution`` sets beside the measured
step.

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



def roofline_terms(*, total_flops: float, total_bytes: float,
                   total_collective_bytes: float, chips: int,
                   hw: HW = HW()) -> dict:
    """All inputs are global (over every card); terms are seconds."""
    compute = total_flops / (chips * hw.peak_flops)
    memory = total_bytes / (chips * hw.hbm_bw)
    collective = total_collective_bytes / (chips * hw.link_bw)
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    bound = max(compute, memory, collective)
    terms.update({
        "dominant": dom.replace("_s", ""),
        "step_lower_bound_s": bound,
        "roofline_fraction": compute / bound if bound > 0 else 0.0,
    })
    return terms


def model_flops(cfg, shape_kind: str, seq_len: int, global_batch: int) -> float:
    """Model FLOPs of an LM config: 6·N·D for training, 2·N·D for a prefill
    (forward only), 2·N per sequence for a decode step; N counts the active
    parameters (a MoE's routed top-k and shared experts)."""
    n_active = active_params(cfg)
    tokens = seq_len * global_batch
    if shape_kind == "train":
        return 6.0 * n_active * tokens
    if shape_kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * global_batch     # decode: one token a sequence


def active_params(cfg) -> float:
    """Parameters a token touches (``models.lmconfig.LMConfig``; MoE: top-k
    and shared experts only)."""
    d, v = cfg.d_model, cfg.vocab
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family in ("dense", "vlm"):
        att = d * (cfg.n_head + 2 * cfg.n_kv_head) * cfg.d_head + \
            cfg.n_head * cfg.d_head * d
        ffn = 3 * d * cfg.d_ff
        n = cfg.n_layer * (att + ffn) + emb
        if cfg.family == "vlm":
            n += cfg.frontend_dim * d + d * d
        return n
    if cfg.family == "moe":
        att = d * (cfg.n_head + 2 * cfg.n_kv_head) * cfg.d_head + \
            cfg.n_head * cfg.d_head * d
        routed = 3 * d * cfg.moe_d_ff * cfg.top_k
        shared = 3 * d * (cfg.shared_d_ff or 0)
        return cfg.n_layer * (att + routed + shared + d * cfg.n_experts) + emb
    if cfg.family == "ssm":
        di, n_s, h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        blk = 2 * d * di + 2 * d * n_s + d * h + di * d
        return cfg.n_layer * blk + emb
    if cfg.family == "hybrid":
        di, n_s, h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        blk = 2 * d * di + 2 * d * n_s + d * h + di * d
        shared_blk = 2 * d * d + d * (cfg.n_head + 2 * cfg.n_kv_head) * \
            cfg.d_head + cfg.n_head * cfg.d_head * d + 3 * d * cfg.d_ff
        n_inv = (cfg.n_layer + cfg.shared_attn_every - 1) // cfg.shared_attn_every
        # the shared block's weights count once as parameters, but are
        # active at each invocation
        return cfg.n_layer * blk + n_inv * shared_blk + emb
    if cfg.family == "audio":
        att = 2 * (d * (cfg.n_head + 2 * cfg.n_kv_head) * cfg.d_head +
                   cfg.n_head * cfg.d_head * d)   # self + cross
        ffn = 2 * d * cfg.d_ff
        dec = cfg.n_layer * (att + ffn)
        enc = cfg.n_enc_layer * (att / 2 + ffn)
        return dec + enc + v * d
    raise ValueError(cfg.family)

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


def predict_step_time(cfg, *, bp: int = 1, dap: int = 1, pod: int = 1,
                      data: int = 1, global_batch: int = 1,
                      n_recycle: float = 1.0, hw: HW = HW(), elt: int = 2,
                      overlap: bool = None) -> dict:
    """Roofline prediction of one training step under a ParallelPlan: the
    main-stack block time (``estimate_block_time``) scaled to the whole
    trunk (extra-MSA stack and structure module) by the FLOP ratio
    ``af2_model_flops / main-stack FLOPs``; ``n_recycle`` forward passes of
    which the last carries the backward; each data-parallel group steps
    over its local batch.  ``model_flops_per_step`` counts the backward at
    twice the forward, on the last cycle only."""
    d_groups = max(pod, 1) * max(data, 1)
    local_batch = global_batch / d_groups
    t_fb = estimate_block_time(cfg, bp=bp, dap=dap, hw=hw, fwd_bwd=True,
                               elt=elt, overlap=overlap)
    t_f = estimate_block_time(cfg, bp=bp, dap=dap, hw=hw, fwd_bwd=False,
                              elt=elt, overlap=overlap)
    f_msa, f_pair = evo_branch_flops(cfg)
    main_fwd = cfg.n_evoformer * (f_msa + f_pair)
    total_fwd = af2_model_flops(cfg, 1.0)
    scale = total_fwd / main_fwd if main_fwd > 0 else 1.0
    nr = max(float(n_recycle), 1.0)
    per_protein = scale * cfg.n_evoformer * ((nr - 1.0) * t_f + t_fb)
    predicted = local_batch * per_protein
    flops_per_protein = af2_model_flops(cfg, nr) + 2.0 * af2_model_flops(cfg, 1.0)
    return {
        "predicted_step_s": predicted,
        "block_fwdbwd_s": t_fb,
        "block_fwd_s": t_f,
        "trunk_scale": scale,
        "local_batch": local_batch,
        "model_flops_per_step": flops_per_protein * global_batch,
        "n_devices": d_groups * max(bp, 1) * max(dap, 1),
    }


def af2_model_flops(cfg, n_recycle: float = 1.0) -> float:
    """Analytic AF2 trunk FLOPs per protein per forward pass (x3 for
    training), the dominant matmuls of every block of both stacks and of
    the IPA layers (s = N_seq, r = N_res, m = c_m, z = c_z)."""
    def evo_block_flops(s, r, m, z, c_att, c_opm, c_mul, heads):
        ha = heads * c_att
        row = 2 * s * r * m * ha * 4 + 2 * s * r * r * ha * 2 + \
            2 * r * r * z * heads
        col = 2 * s * r * m * ha * 4 + 2 * r * s * s * ha * 2
        mtrans = 2 * s * r * m * 4 * m * 2
        opm = 2 * s * r * m * c_opm * 2 + 2 * r * r * s * c_opm * c_opm + \
            2 * r * r * c_opm * c_opm * z
        tri_mul = 2 * (2 * r * r * z * c_mul * 3 + 2 * r * r * r * c_mul +
                       2 * r * r * c_mul * z)
        tri_att = 2 * (2 * r * r * z * 4 * 32 * 4 + 2 * r * r * r * 4 * 32 * 2 +
                       2 * r * r * z * 4)
        ptrans = 2 * r * r * z * 4 * z * 2
        return row + col + mtrans + opm + tri_mul + tri_att + ptrans

    e = cfg.evoformer
    main = cfg.n_evoformer * evo_block_flops(
        cfg.n_seq, cfg.n_res, e.c_m, e.c_z, e.c_hidden_att, e.c_hidden_opm,
        e.c_hidden_mul, e.n_head_msa)
    x = cfg.extra
    extra = cfg.n_extra_msa_blocks * evo_block_flops(
        cfg.n_extra_seq, cfg.n_res, x.c_m, x.c_z, x.c_hidden_att,
        x.c_hidden_opm, x.c_hidden_mul, x.n_head_msa)
    st = cfg.structure
    ipa = st.n_layer * (2 * cfg.n_res * st.c_s * st.n_head * st.c_hidden * 3 +
                        2 * cfg.n_res * cfg.n_res * st.n_head *
                        (st.c_hidden + st.c_z + st.n_qk_points * 3) +
                        2 * cfg.n_res * st.c_s * st.c_s * 4)
    return n_recycle * (main + extra + ipa)
