"""What each kernel costs and holds, from its shapes alone: the operations it
does and the bytes it must move (each input read once, each output written
once), and the scratch its wrapper allocates.

``chip_smoke.py`` prices each kernel's bound from the ``*_cost`` functions
(``bound_ms``); the dry run (``analysis/cost.py``) counts a kernel node's
operations and bytes by them.  The ``*_scratch`` functions size the
scratch of K2-K5: the CUDA wrappers (``kernels/evo_attention.py``,
``kernels/triangle.py``) allocate what they give and the kernels' meta
route (``kernels/meta.py``) the same, so the dry run's peak holds what the
card allocates.  Each launch checks the size it is handed against the
kernel's own layout (``workspace_need`` in ``csrc/evo_attention_bwd.cu``,
``scratch_need`` in ``csrc/triangle_mult_fwd.cu``, ``epilogue_need`` /
``dx_need`` in ``csrc/triangle_mult_bwd.cu``) and refuses less; the tile
constants below are the C sources' (``tests/test_torch_dryrun.py`` reads
them there).
Every ``*_cost`` returns ``(operations, bytes)``; ``el`` is the bytes of one
activation element (2 for bf16, 4 for fp32).
"""
from __future__ import annotations

# ---------------------------------------------------------------------------
# Operations and bytes
# ---------------------------------------------------------------------------


def evo_attention_fwd_cost(L, S, H, C, el, *, bias_el=0, gated=True,
                           lse=False):
    """K1: q, k, v (and the gate) read, the output written, the (H, S, S)
    bias read (``bias_el`` bytes an element, 0 without a bias), and with
    ``lse`` the fp32 (L*H, S) log-sum-exps written."""
    act = L * S * H * C * el
    flops = 4.0 * L * H * S * S * C
    nbytes = (4 + int(gated)) * act + H * S * S * bias_el
    if lse:
        nbytes += L * H * S * 4
    return flops, nbytes


def evo_attention_bwd_cost(L, S, H, C, el, *, bias_el=0, gated=True):
    """K2: q, k, v, the gate, out, do read and dq, dk, dv, dgate written
    (8 activations without a gate), the bias read and its fp32 gradient
    written, the log-sum-exps read."""
    act = L * S * H * C * el
    flops = 10.0 * L * H * S * S * C
    nbytes = (10 if gated else 8) * act + L * H * S * 4
    if bias_el:
        nbytes += H * S * S * (bias_el + 4)
    return flops, nbytes


def triangle_param_elems(c_z, c) -> int:
    """Elements of K3's parameters: w_a, b_a, w_b, b_b (c_z x 2c, 2c each),
    the LayerNorm's scale and bias (c), w_o (c x c_z), b_o, w_g (c_z x c_z)
    and b_g."""
    return 2 * (c_z * 2 * c + 2 * c) + 2 * c + c * c_z + c_z + c_z * c_z + c_z


def triangle_mult_fwd_cost(r_i, r_j, r_k, c_z, c, el, *, act_rows=None,
                           s=False, masked=False):
    """K3: the gated projections of xa (r_i x r_k rows) and xb (r_j x r_k),
    the k-contraction, the out- and gate projections of the r_i x r_j
    pairs.  ``act_rows``: the pair rows of c_z activations read (default
    xa, xb and xg apart; fewer where they view one tensor), plus the output
    written; with ``s`` the fp32 contraction written; with ``masked`` the
    fp32 (r_k,) mask read."""
    P = r_i * r_j
    flops = (2.0 * (r_i * r_k + r_j * r_k) * c_z * 2 * c
             + 2.0 * P * r_k * c + 2.0 * P * c * c_z + 2.0 * P * c_z * c_z)
    if act_rows is None:
        act_rows = r_i * r_k + r_j * r_k + P
    nbytes = ((act_rows + P) * c_z * el + triangle_param_elems(c_z, c) * el
              + (P * c * 4 if s else 0) + (r_k * 4 if masked else 0))
    return flops, nbytes


def triangle_mult_bwd_epilogue_cost(P, c_z, c, el):
    """K4 over ``P`` pairs: s read and ds written (fp32), xg, dy read and
    dxg written, W_o and W_g read and their fp32 gradients written."""
    flops = 6 * 2.0 * P * c * c_z
    nbytes = (P * c * 4 * 2 + 3 * P * c_z * el
              + (c * c_z + c_z * c_z) * (el + 4))
    return flops, nbytes


def triangle_mult_bwd_dx_cost(r_p, r_q, r_k, c_z, c, el):
    """K5 for one operand side: ds (r_p, r_q, c) fp32 read, x_loc (r_p r_k
    rows) and x_str (r_q r_k rows) read, dx_loc written, both projections'
    weights read and the fp32 dW written."""
    n, m = r_p * r_k, r_q * r_k
    flops = (2.0 * r_p * r_q * r_k * c + 2 * 2.0 * n * c_z * 2 * c
             + 2 * 2.0 * m * c_z * 2 * c)
    nbytes = (r_p * r_q * c * 4 + (n + m) * c_z * el + n * c_z * el
              + 2 * c_z * 2 * c * el + c_z * 2 * c * 4)
    return flops, nbytes


def causal_pairs(s: int, t: int) -> int:
    """(query, key) pairs a causal mask keeps: query i sees keys 0..i."""
    k = min(s, t)
    return k * (k + 1) // 2 + (s - k) * t


def flash_attention_fwd_cost(B, S, T, H, KV, D, el, *, causal=True):
    """K6: the (query, key) pairs the mask keeps (all of them without it),
    q and the output, k and v moved once."""
    pairs = causal_pairs(S, T) if causal else S * T
    flops = 4.0 * B * H * D * pairs
    nbytes = (2 * B * S * H * D + 2 * B * T * KV * D) * el
    return flops, nbytes


# ---------------------------------------------------------------------------
# Scratch the wrappers allocate (bytes for K2 and K3, fp32 elements for K4
# and K5), by the kernels' layouts
# ---------------------------------------------------------------------------

def _align256(x: int) -> int:
    return (x + 255) // 256 * 256


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def _round_up(x: int, m: int) -> int:
    return _cdiv(x, m) * m


# csrc/evo_attention_bwd.cu
_K2_TQ, _K2_RT = 16, 64


def _k2_dbias_chunks(L, S, H) -> int:
    per_chunk = H * _cdiv(S, _K2_TQ)
    n = min(max(_cdiv(2048, per_chunk), 1), L)
    rows = _cdiv(L, n)
    return _cdiv(L, rows)


def evo_attention_bwd_scratch(L, S, H, C, dtype_code, bias_code, has_bias,
                              has_gate, bias_misaligned=False) -> int:
    """The K2 wrapper's workspace bytes (dtype codes 0 fp32, 1 bf16;
    ``bias_misaligned``: the bias's data does not start on 16 bytes)."""
    if dtype_code == 0:
        n_chunks = _k2_dbias_chunks(L, S, H)
        return (_align256(L * H * S * 4)
                + (_align256(n_chunks * H * S * S * 4)
                   if has_bias and n_chunks > 1 else 0))
    per = 8 if bias_code == 1 else 4
    pack = bool(has_bias) and (S % per != 0 or bool(bias_misaligned))
    bt = 4 if (has_bias and bias_code == 0) else 2   # the bias tile's type
    nw = 4 if bt == 2 else 2                          # key tiles a window
    nt = _cdiv(S, _K2_RT)
    nwin = _cdiv(nt, nw)
    tiles = H * nt * nwin
    n = min(max((132 if has_bias else 264) // tiles, 1), L)
    rows_per_part = _cdiv(L, n)
    n_part = _cdiv(L, rows_per_part)
    bp = _cdiv(S, 16 // bt) * (16 // bt) if pack else S
    off = _align256(L * H * S * 4)
    if has_gate:
        off += _align256(L * S * H * C * 2)
    if pack:
        off += _align256(H * S * bp * bt)
    if has_bias and n_part > 1:
        off += _align256(n_part * H * S * S * 4)
    if nwin > 1:
        off += _align256(nwin * L * S * H * C * 4)
    return off


# csrc/tile_mma.cuh
_BM, _BN, _BK, _PAD = 128, 64, 32, 128


def triangle_mult_fwd_scratch(r_i, r_j, r_k, c, dtype_code) -> int:
    """The K3 wrapper's scratch bytes."""
    if dtype_code == 1:
        Ri, Rj, Rk = (_round_up(x, _PAD) for x in (r_i, r_j, r_k))
        return (_align256(2 * c * Ri * Rk) + _align256(2 * c * Rj * Rk)
                + _align256(4 * c * Ri * Rj))
    return (r_i + r_j) * r_k * c * 4


# csrc/triangle_mult_bwd.cu
_OT, _OP, _OUTER_BLOCKS, _EP = 64, 16, 512, 32
_EPI_WARPS, _EPI_ROWS, _EPI_MAX_BLOCKS = 8, 16, 1024


def _outer_nsplit(P, M, N) -> int:
    tiles = _cdiv(M, _OT) * _cdiv(N, _OT)
    nsplit = min(_OUTER_BLOCKS // tiles, _cdiv(P, _OP))
    nsplit = max(nsplit, 1)
    rows = _cdiv(P, nsplit)
    return _cdiv(P, rows)


def _split_steps(ksteps, nsplit) -> int:
    nsplit = min(max(nsplit, 1), ksteps)
    steps = _cdiv(ksteps, nsplit)
    return _cdiv(ksteps, steps)


def triangle_mult_bwd_epilogue_scratch(P, c_z, c, dtype_code) -> int:
    """The K4 wrapper's scratch, in fp32 elements."""
    if dtype_code == 1:
        nb = _cdiv(_cdiv(P, _EPI_ROWS), _EPI_WARPS)
        nblk_max = min(nb, _EPI_MAX_BLOCKS)
        ksteps = _cdiv(P, _BK)
        t_o = _cdiv(c, _BM) * _cdiv(c_z, _BN)
        t_g = _cdiv(c_z, _BM) * _cdiv(c_z, _BN)
        nsplit = _split_steps(ksteps, _OUTER_BLOCKS // 2 // max(t_o, t_g))
        nbytes = (2 * _align256(2 * P * c) + 4 * _align256(2 * P * c_z)
                  + _align256(4 * nblk_max * (2 * c + 2 * c_z))
                  + _align256(4 * nsplit * c * c_z)
                  + _align256(4 * nsplit * c_z * c_z))
        return _cdiv(nbytes, 4)
    o1 = _outer_nsplit(P, c, c_z) * c * c_z
    o2 = _outer_nsplit(P, c_z, c_z) * c_z * c_z
    return P * c + 2 * P * c_z + _cdiv(P, _EP) * (2 * c + 2 * c_z) + max(o1, o2)


def triangle_mult_bwd_dx_scratch(r_p, r_q, r_k, c_z, c, dtype_code) -> int:
    """The K5 wrapper's scratch, in fp32 elements."""
    if dtype_code == 1:
        Rp, Rq, Rk = (_round_up(x, _PAD) for x in (r_p, r_q, r_k))
        Pp = Rp * Rk
        ntiles = (Rp // _BM) * (Rk // _BN)
        ksteps = Pp // _BK
        wtiles = _cdiv(c_z, _BN) * _cdiv(2 * c, _BM)
        nsplit = _split_steps(ksteps, _OUTER_BLOCKS // wtiles)
        ds_n, st_n, h_n = c * Rp * Rq, c * Rq * Rk, 2 * c * Pp
        nbytes = (2 * _align256(2 * ds_n) + 2 * _align256(2 * st_n)
                  + _align256(4 * h_n) + 2 * _align256(2 * h_n)
                  + _align256(4 * ntiles * 2 * c)
                  + _align256(4 * nsplit * c_z * 2 * c))
        return _cdiv(nbytes, 4)
    P = r_p * r_k
    return (r_q * r_k * c + P * c + P * 2 * c + _cdiv(P, _EP) * 2 * c
            + _outer_nsplit(P, c_z, 2 * c) * c_z * 2 * c)
