"""Evoformer: MSA branch, pair branch, outer-product mean, and the three
block variants of paper Fig. 1 (counterpart of ``repro/core/evoformer.py``).

* ``af2``      — serial (Fig 1a): MSA stack -> OPM -> pair stack.
* ``multimer`` — OPM first (Fig 1b): OPM -> {MSA stack, pair stack}.
* ``parallel`` — OPM last (Fig 1c): the two branches read only the block's
  inputs; the OPM lands at the end of the block.

All functions work on one protein: ``msa`` (s, r, c_m), ``pair`` (r, r, c_z).
Dropout (training, ``deterministic=False``) is AF2's shared-axis dropout.
Its randomness comes from an ``rng``, the port's counterpart of a JAX key:
a tuple of ints, or a :class:`Key` whose per-step words live in a device
tensor (a captured training step replays with new words), extended on the
host by :func:`fold_in` at every level (sample, cycle, stack, block,
branch, site).  Each dropout site hashes its key with the mask's element
index, so recomputing a block under ``torch.utils.checkpoint`` draws the
very same masks.

Impls: ``attention_impl="evo_pallas"`` and ``tri_mult_impl="pallas"`` go
through ``kernels.ops`` — the hand-written CUDA kernels for CUDA tensors,
their plain versions for CPU tensors, with no fallback to anything else on
the card; ``"reference"`` is plain torch.  The reference's XLA ``chunked``
impls are not ported.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch import trace_hooks
from repro_torch.core.config import EvoformerConfig
from repro_torch.kernels import ops as kops
from repro_torch.nn.layers import Dense, LayerNorm, dense, layernorm


class EvoMasks(NamedTuple):
    """Validity masks for a padded protein: ``rows`` (s,) valid MSA rows of
    this stack, ``res`` (r,) valid residues; 1.0 real, 0.0 bucket padding."""
    rows: torch.Tensor
    res: torch.Tensor


def mask_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """(S,) validity -> (S,) additive fp32 attention bias: 0 valid, -1e9 padded."""
    return (key_mask.float() - 1.0) * 1e9


# ---------------------------------------------------------------------------
# Dropout with shared axes (AF2 row-/column-wise dropout)
# ---------------------------------------------------------------------------

class Key(NamedTuple):
    """A dropout key in two parts, so that a captured training step draws
    new masks at every replay.  ``lanes``: a (2,) int64 tensor on the
    device, two 32-bit words mixed from the per-step words (seed, step) by
    :func:`key_lanes`; a captured step reads it from a static buffer that is
    written before each replay.  ``path``: the static sub-stream indices
    (protein, cycle, stack, block, branch, site), appended to on the host by
    :func:`fold_in`."""
    lanes: torch.Tensor
    path: Tuple[int, ...] = ()


# an rng: None (no dropout), a tuple of ints (every word on the host), or a Key
Rng = Optional[Union[Tuple[int, ...], Key]]

_M32 = 0xFFFFFFFF
# starting words of the lanes of a key's words and of its path (digits of
# pi); different for the two, so that words and path never trade places
_WORD_SEEDS = (0x243F6A88, 0x85A308D3)
_PATH_SEEDS = (0x13198A2E, 0x03707344)


def fold_in(rng: Rng, i: int) -> Rng:
    """The rng of sub-stream ``i`` (``jax.random.fold_in``'s counterpart);
    None stays None."""
    if rng is None:
        return None
    if isinstance(rng, Key):
        return Key(rng.lanes, (*rng.path, int(i)))
    return (*rng, int(i))


def _mix32(x):
    """A 32-bit integer finaliser (Wellons' lowbias32 family; both
    multipliers below 2^31) of a Python int or an int64 tensor holding
    values in [0, 2^32).  Masking to 32 bits before each multiply keeps
    every product below 2^63, so the CPU and the card give the same bits."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def key_lanes(words, seeds=_WORD_SEEDS) -> Tuple[int, int]:
    """Two 32-bit lanes mixed on the host from a tuple of ints (each below
    2^63 in magnitude), starting from ``seeds``: nearby tuples give
    unrelated lanes."""
    lanes = []
    for h in seeds:
        for w in words:
            h = _mix32(h ^ (int(w) & _M32))
            h = _mix32(h ^ ((int(w) >> 32) & _M32))
        lanes.append(h)
    return lanes[0], lanes[1]


def dropout_key(words, device) -> Key:
    """The :class:`Key` of the per-step ``words`` (e.g. (seed, step)) on
    ``device``, with an empty path."""
    return Key(torch.tensor(key_lanes(words), dtype=torch.int64,
                            device=device))


def shared_dropout(x: torch.Tensor, rate: float, *, shared_axis: int,
                   rng: Rng, deterministic: bool) -> torch.Tensor:
    """Dropout whose keep-mask is shared along ``shared_axis`` (one draw per
    row or column), kept entries scaled by 1 / (1 - rate).

    The mask is a counter-based hash of the mask's element index under a
    64-bit key, in plain int64 ops on x's device: a Key's device lanes xor
    the host lanes of its path (a tuple's lanes are all mixed on the host),
    and an element is kept when its 32-bit hash lies below
    (1 - rate) * 2^32.  The
    same rng gives the same mask, on the CPU and on the card, and nothing
    is drawn from torch's generators, so a recompute under
    ``torch.utils.checkpoint`` repeats the mask by construction.  While an
    op trace records, the draw is a dropout-site node (the key's source and
    path, and the site) for the RNG audit."""
    if deterministic or rate == 0.0 or rng is None:
        return x
    if trace_hooks.ACTIVE is not None:
        trace_hooks.record_dropout(rng)
    shape = list(x.shape)
    shape[shared_axis] = 1
    if isinstance(rng, Key):
        p0, p1 = key_lanes(rng.path, _PATH_SEEDS)
        k0, k1 = rng.lanes[0] ^ p0, rng.lanes[1] ^ p1
    else:
        k0, k1 = key_lanes(rng)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=x.device)
    h = _mix32(_mix32(idx ^ k0) ^ k1)
    keep = (h < round((1.0 - rate) * 2 ** 32)).reshape(shape)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _not_ported(kind: str, impl: str):
    return ValueError(
        f"{kind}={impl!r} is not ported; the port has 'evo_pallas' / 'pallas' "
        "(the CUDA kernels, plain torch on CPU tensors) and 'reference'")


# ---------------------------------------------------------------------------
# Gated attention (AF2 suppl. Algorithm 7): MSA row/column + triangle attention
# ---------------------------------------------------------------------------

class GatedAttention(nn.Module):
    def __init__(self, c_in: int, c_hidden: int, n_head: int, *,
                 generator: torch.Generator, c_bias_in: Optional[int] = None):
        super().__init__()
        g, hc = generator, n_head * c_hidden
        self.ln = LayerNorm(c_in)
        self.q = Dense(c_in, hc, use_bias=False, generator=g)
        self.k = Dense(c_in, hc, use_bias=False, generator=g)
        self.v = Dense(c_in, hc, use_bias=False, generator=g)
        self.gate = Dense(c_in, hc, scale="zeros", generator=g)
        self.out = Dense(hc, c_in, scale="zeros", generator=g)
        with torch.no_grad():
            self.gate.b.fill_(1.0)  # AF2 gating init: sigmoid(0 + 1), open gate
        if c_bias_in is not None:
            self.bias_ln = LayerNorm(c_bias_in)
            self.bias_proj = Dense(c_bias_in, n_head, use_bias=False, generator=g)


def project_attention_bias(p: GatedAttention, bias_input: torch.Tensor):
    """(S, S', c_z) -> (h, S, S') attention bias (LN + headwise projection)."""
    zb = layernorm(p.bias_ln, bias_input)
    return torch.movedim(dense(p.bias_proj, zb), -1, -3)


def attention_reference(q, k, v, bias: Optional[torch.Tensor] = None):
    """Naive softmax attention along S: q/k/v (..., S, H, C), bias
    broadcastable to (..., H, S, S); logits and softmax in fp32."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("...shc,...thc->...hst", q, k).float() * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("...hst,...thc->...shc", probs, v)


def gated_attention(p: GatedAttention, x: torch.Tensor, *, n_head: int,
                    c_hidden: int, bias_input: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    key_mask: Optional[torch.Tensor] = None,
                    attention_impl: str = "evo_pallas") -> torch.Tensor:
    """x (..., L, S, c): attention along S independently for each lead row.

    ``bias_input`` (S, S, c_z) is projected to the (h, S, S) bias; ``key_mask``
    (S,) is folded into that bias, so the kernel masks through its bias add.
    """
    h, q, k, v = attention_qkv(p, x, n_head=n_head, c_hidden=c_hidden)
    if bias_input is not None:
        assert bias is None
        bias = project_attention_bias(p, bias_input)            # (h, S, S)
    return attend(p, x, h, q, k, v, bias=bias, key_mask=key_mask,
                  attention_impl=attention_impl)


def attention_qkv(p: GatedAttention, x: torch.Tensor, *, n_head: int,
                  c_hidden: int) -> tuple:
    """The head of :func:`gated_attention`: (h, q, k, v), the LayerNorm of
    x (..., L, S, c) and its q/k/v projections (..., L, S, n_head,
    c_hidden)."""
    h = layernorm(p.ln, x)
    *lead, s, _ = x.shape
    q = dense(p.q, h).reshape(*lead, s, n_head, c_hidden)
    k = dense(p.k, h).reshape(*lead, s, n_head, c_hidden)
    v = dense(p.v, h).reshape(*lead, s, n_head, c_hidden)
    return h, q, k, v


def attend(p: GatedAttention, x: torch.Tensor, h, q, k, v, *,
           bias: Optional[torch.Tensor] = None,
           key_mask: Optional[torch.Tensor] = None,
           attention_impl: str = "evo_pallas") -> torch.Tensor:
    """The rest of :func:`gated_attention` from :func:`attention_qkv`'s
    outputs: the gated attention with the (h, S, S) ``bias`` and
    ``key_mask`` folded into it, and the output projection."""
    *lead, s, n_head, c_hidden = q.shape
    if key_mask is not None:
        base = 0.0 if bias is None else bias.float()
        bias = (base + mask_bias(key_mask)).expand(n_head, s, s)
    if attention_impl == "evo_pallas":
        gate = dense(p.gate, h).reshape(*lead, s, n_head, c_hidden)
        flat = lambda t: t.reshape(-1, s, n_head, c_hidden)
        if bias is None:
            o = kops.evo_attention_nobias(flat(q), flat(k), flat(v), flat(gate))
        else:
            o = kops.evo_attention(flat(q), flat(k), flat(v),
                                   bias.contiguous(), flat(gate))
        o = o.reshape(*lead, s, n_head * c_hidden).to(x.dtype)
        return dense(p.out, o)
    if attention_impl != "reference":
        raise _not_ported("attention_impl", attention_impl)
    o = attention_reference(q, k, v, bias)
    g = torch.sigmoid(dense(p.gate, h))
    o = (g * o.reshape(*lead, s, n_head * c_hidden)).to(x.dtype)
    return dense(p.out, o)


class GlobalAttention(nn.Module):
    def __init__(self, c_in: int, c_hidden: int, n_head: int, *,
                 generator: torch.Generator):
        super().__init__()
        g, hc = generator, n_head * c_hidden
        self.ln = LayerNorm(c_in)
        self.q = Dense(c_in, hc, use_bias=False, generator=g)
        self.k = Dense(c_in, c_hidden, use_bias=False, generator=g)
        self.v = Dense(c_in, c_hidden, use_bias=False, generator=g)
        self.gate = Dense(c_in, hc, scale="zeros", generator=g)
        self.out = Dense(hc, c_in, scale="zeros", generator=g)
        with torch.no_grad():
            self.gate.b.fill_(1.0)


def global_attention(p: GlobalAttention, x: torch.Tensor, *, n_head: int,
                     c_hidden: int,
                     key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Global (mean-query) attention along S (AF2 Algorithm 19), plain
    torch (not a Pallas kernel in the reference either).  ``key_mask`` (S,)
    drops padded rows from the averaged query and from the softmax."""
    h = layernorm(p.ln, x)
    *lead, s, _ = x.shape
    if key_mask is not None:
        km = key_mask.to(h.dtype)
        q_avg = ((h * km[:, None]).sum(-2)
                 / torch.clamp(km.sum(), min=1.0).to(h.dtype))
    else:
        q_avg = h.mean(-2)                                          # (..., c)
    q = dense(p.q, q_avg).reshape(*lead, n_head, c_hidden)
    q = q * (c_hidden ** -0.5)
    k = dense(p.k, h)                                               # (..., S, c_h)
    v = dense(p.v, h)
    logits = torch.einsum("...hc,...sc->...hs", q, k).float()
    if key_mask is not None:
        logits = logits + mask_bias(key_mask)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    # fp32 accumulation of w·v, as the reference forces it
    o = torch.einsum("...hs,...sc->...hc", w.float(), v.float()).to(v.dtype)
    g = torch.sigmoid(dense(p.gate, h))                             # (..., S, h*c)
    o = g * o.reshape(*lead, 1, n_head * c_hidden)
    return dense(p.out, o.to(x.dtype))


# ---------------------------------------------------------------------------
# Transition (Algorithm 9/15)
# ---------------------------------------------------------------------------

class Transition(nn.Module):
    def __init__(self, c: int, factor: int, *, generator: torch.Generator):
        super().__init__()
        self.ln = LayerNorm(c)
        self.w1 = Dense(c, factor * c, generator=generator)
        self.w2 = Dense(factor * c, c, scale="zeros", generator=generator)


def transition(p: Transition, x: torch.Tensor) -> torch.Tensor:
    return dense(p.w2, torch.relu(dense(p.w1, layernorm(p.ln, x))))


# ---------------------------------------------------------------------------
# Outer product mean (Algorithm 10), fused: the (r, r, c^2) tensor never exists
# ---------------------------------------------------------------------------

class OuterProductMean(nn.Module):
    def __init__(self, c_m: int, c_hidden: int, c_z: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.ln = LayerNorm(c_m)
        self.a = Dense(c_m, c_hidden, generator=generator)
        self.b = Dense(c_m, c_hidden, generator=generator)
        self.out = Dense(c_hidden * c_hidden, c_z, scale="zeros",
                         generator=generator)


def opm_contract(a, b, w, b_out, denom, out_dtype, row_chunk: int = 32):
    """``out[i,j] = ((Σ_s a[s,i] ⊗ b[s,j]) / denom) · W``, residue rows in
    chunks of ``row_chunk`` so the peak temporary is (row_chunk, r_j, c·d);
    the s-sum accumulates in fp32, as the reference forces it."""
    r_i = a.shape[1]
    bf = b.float()
    outs = []
    for i0 in range(0, r_i, row_chunk):
        outer = torch.einsum("sic,sjd->ijcd", a[:, i0:i0 + row_chunk].float(),
                             bf) / denom
        outer = outer.to(out_dtype).flatten(-2)
        outs.append(outer @ w)
    return torch.cat(outs, 0) + b_out


def outer_product_mean_fused(p: OuterProductMean, msa: torch.Tensor, *,
                             row_chunk: int = 32,
                             row_mask: Optional[torch.Tensor] = None):
    h = layernorm(p.ln, msa)
    a = dense(p.a, h)                                         # (s, r, c)
    b = dense(p.b, h)
    denom = float(msa.shape[0])
    if row_mask is not None:
        rm = row_mask.to(a.dtype)[:, None, None]
        a, b = a * rm, b * rm
        denom = torch.clamp(row_mask.float().sum(), min=1.0)
    return opm_contract(a, b, p.out.w, p.out.b, denom, msa.dtype,
                        row_chunk=row_chunk)


def opm_apply(p: OuterProductMean, cfg: EvoformerConfig, msa: torch.Tensor,
              row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if cfg.opm_impl != "fused":
        raise _not_ported("opm_impl", cfg.opm_impl)
    return outer_product_mean_fused(p, msa, row_chunk=cfg.opm_chunk,
                                    row_mask=row_mask)


# ---------------------------------------------------------------------------
# Triangle multiplicative update (Algorithms 11/12)
# ---------------------------------------------------------------------------

class TriangleMult(nn.Module):
    def __init__(self, c_z: int, c_hidden: int, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.ln_in = LayerNorm(c_z)
        self.a = Dense(c_z, c_hidden, generator=g)
        self.a_gate = Dense(c_z, c_hidden, scale="zeros", generator=g)
        self.b = Dense(c_z, c_hidden, generator=g)
        self.b_gate = Dense(c_z, c_hidden, scale="zeros", generator=g)
        self.ln_out = LayerNorm(c_hidden)
        self.out = Dense(c_hidden, c_z, scale="zeros", generator=g)
        self.gate = Dense(c_z, c_z, scale="zeros", generator=g)
        with torch.no_grad():
            for m in (self.a_gate, self.b_gate, self.gate):
                m.b.fill_(1.0)


def triangle_mult(p: TriangleMult, z: torch.Tensor, *, outgoing: bool,
                  k_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain triangle-multiplicative update (the reference impl): the
    k-contraction accumulates in fp32; ``k_mask`` (r,) zeroes padded
    residues' k terms (their gated projection is not zero)."""
    x = layernorm(p.ln_in, z)
    a = torch.sigmoid(dense(p.a_gate, x)) * dense(p.a, x)
    b = torch.sigmoid(dense(p.b_gate, x)) * dense(p.b, x)
    if k_mask is not None:
        km = k_mask.to(a.dtype)
        a = a * (km[None, :, None] if outgoing else km[:, None, None])
    eq = "ikc,jkc->ijc" if outgoing else "kic,kjc->ijc"
    o = torch.einsum(eq, a.float(), b.float())
    o = dense(p.out, layernorm(p.ln_out, o.to(z.dtype)))
    g = torch.sigmoid(dense(p.gate, x))
    return (g * o).to(z.dtype)


def tri_mult_packed_weights(p: TriangleMult):
    """[value | gate] packing of the a/b projections for the kernel."""
    w_a = torch.cat([p.a.w, p.a_gate.w], 1)
    b_a = torch.cat([p.a.b, p.a_gate.b])
    w_b = torch.cat([p.b.w, p.b_gate.w], 1)
    b_b = torch.cat([p.b.b, p.b_gate.b])
    return w_a, b_a, w_b, b_b


def triangle_mult_fused(p: TriangleMult, xa, xb, xg, *, impl: str,
                        out_dtype=None,
                        k_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K3 on oriented operands: ``o[i,j] = Σ_k a(xa[i,k]) ⊙ b(xb[j,k])``
    then LN, out-projection and the gate from ``xg`` (see ``kernels.ref``)."""
    if impl != "pallas":
        raise _not_ported("tri_mult_impl", impl)
    out_dtype = out_dtype or xg.dtype
    packed = (*tri_mult_packed_weights(p), p.ln_out.scale, p.ln_out.bias,
              p.out.w, p.out.b, p.gate.w, p.gate.b)
    if k_mask is None:
        y = kops.triangle_mult(xa, xb, xg, *packed)
    else:
        y = kops.triangle_mult_masked(xa, xb, xg, k_mask, *packed)
    return y.to(out_dtype)


def tri_mult_apply(p: TriangleMult, cfg: EvoformerConfig, z: torch.Tensor, *,
                   outgoing: bool,
                   k_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch on ``cfg.tri_mult_impl`` ('reference' | 'pallas').  No
    fallback: the kernel masks ragged tiles, so it takes any r."""
    impl = cfg.tri_mult_impl
    if impl == "reference":
        return triangle_mult(p, z, outgoing=outgoing, k_mask=k_mask)
    x = layernorm(p.ln_in, z)
    xab = x if outgoing else x.transpose(0, 1)   # k on axis 1 either way
    return triangle_mult_fused(p, xab, xab, x, impl=impl, out_dtype=z.dtype,
                               k_mask=k_mask)


# ---------------------------------------------------------------------------
# Evoformer block: branches + variants
# ---------------------------------------------------------------------------

class EvoformerBlock(nn.Module):
    def __init__(self, cfg: EvoformerConfig, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.row_attn = GatedAttention(cfg.c_m, cfg.c_hidden_att, cfg.n_head_msa,
                                       c_bias_in=cfg.c_z, generator=g)
        col = GlobalAttention if cfg.global_column_attn else GatedAttention
        self.col_attn = col(cfg.c_m, cfg.c_hidden_att, cfg.n_head_msa,
                            generator=g)
        self.msa_trans = Transition(cfg.c_m, cfg.transition_factor, generator=g)
        self.opm = OuterProductMean(cfg.c_m, cfg.c_hidden_opm, cfg.c_z,
                                    generator=g)
        self.tri_mul_out = TriangleMult(cfg.c_z, cfg.c_hidden_mul, generator=g)
        self.tri_mul_in = TriangleMult(cfg.c_z, cfg.c_hidden_mul, generator=g)
        self.tri_att_start = GatedAttention(
            cfg.c_z, cfg.c_hidden_pair_att, cfg.n_head_pair, c_bias_in=cfg.c_z,
            generator=g)
        self.tri_att_end = GatedAttention(
            cfg.c_z, cfg.c_hidden_pair_att, cfg.n_head_pair, c_bias_in=cfg.c_z,
            generator=g)
        self.pair_trans = Transition(cfg.c_z, cfg.transition_factor, generator=g)


def msa_branch(p: EvoformerBlock, cfg: EvoformerConfig, msa, z_bias_src, *,
               rng: Rng = None, deterministic: bool = True,
               masks: Optional[EvoMasks] = None):
    """Row attention (pair-biased, row-wise dropout) -> column attention ->
    transition.  Row attention masks padded residue keys; column attention
    padded MSA rows."""
    impl = cfg.attention_impl
    rows_mask = res_mask = None
    if masks is not None:
        rows_mask, res_mask = masks.rows, masks.res
    upd = gated_attention(p.row_attn, msa, n_head=cfg.n_head_msa,
                          c_hidden=cfg.c_hidden_att, bias_input=z_bias_src,
                          key_mask=res_mask, attention_impl=impl)
    msa = msa + shared_dropout(upd, cfg.dropout_msa, shared_axis=0,
                               rng=fold_in(rng, 0), deterministic=deterministic)
    cols = msa.transpose(0, 1)
    if cfg.global_column_attn:
        col = global_attention(p.col_attn, cols, n_head=cfg.n_head_msa,
                               c_hidden=cfg.c_hidden_att, key_mask=rows_mask)
    else:
        col = gated_attention(p.col_attn, cols, n_head=cfg.n_head_msa,
                              c_hidden=cfg.c_hidden_att, key_mask=rows_mask,
                              attention_impl=impl)
    msa = msa + col.transpose(0, 1)
    return msa + transition(p.msa_trans, msa)


def pair_branch(p: EvoformerBlock, cfg: EvoformerConfig, z, *,
                rng: Rng = None, deterministic: bool = True,
                masks: Optional[EvoMasks] = None):
    """Triangle updates + triangle attention (each with shared-axis
    dropout) + transition; ``masks.res`` masks the k-contractions and the
    triangle-attention keys."""
    impl = cfg.attention_impl
    res_mask = masks.res if masks is not None else None

    def drop(site, x, shared_axis):
        return shared_dropout(x, cfg.dropout_pair, shared_axis=shared_axis,
                              rng=fold_in(rng, site),
                              deterministic=deterministic)

    z = z + drop(0, tri_mult_apply(p.tri_mul_out, cfg, z, outgoing=True,
                                   k_mask=res_mask), 0)
    z = z + drop(1, tri_mult_apply(p.tri_mul_in, cfg, z, outgoing=False,
                                   k_mask=res_mask), 0)
    z = z + drop(2, gated_attention(p.tri_att_start, z, n_head=cfg.n_head_pair,
                                    c_hidden=cfg.c_hidden_pair_att,
                                    bias_input=z, key_mask=res_mask,
                                    attention_impl=impl), 0)
    zt = z.transpose(0, 1)
    att_end = gated_attention(p.tri_att_end, zt, n_head=cfg.n_head_pair,
                              c_hidden=cfg.c_hidden_pair_att, bias_input=zt,
                              key_mask=res_mask, attention_impl=impl)
    z = z + drop(3, att_end.transpose(0, 1), 1)
    return z + transition(p.pair_trans, z)


def evoformer_block(p: EvoformerBlock, cfg: EvoformerConfig, msa, z, *,
                    rng: Rng = None, deterministic: bool = True,
                    masks: Optional[EvoMasks] = None):
    """Dispatch on ``cfg.variant`` (paper Fig 1a/1b/1c); the variants only
    reorder the same three pieces.  The MSA and pair branches draw their
    dropout from sub-streams 0 and 1 of ``rng``."""
    row_mask = masks.rows if masks is not None else None
    kw = dict(deterministic=deterministic, masks=masks)
    rm, rz = fold_in(rng, 0), fold_in(rng, 1)
    if cfg.variant == "af2":
        msa_out = msa_branch(p, cfg, msa, z, rng=rm, **kw)
        z = z + opm_apply(p.opm, cfg, msa_out, row_mask=row_mask)
        return msa_out, pair_branch(p, cfg, z, rng=rz, **kw)
    if cfg.variant == "multimer":
        z = z + opm_apply(p.opm, cfg, msa, row_mask=row_mask)
        msa_out = msa_branch(p, cfg, msa, z, rng=rm, **kw)
        return msa_out, pair_branch(p, cfg, z, rng=rz, **kw)
    if cfg.variant == "parallel":
        msa_out = msa_branch(p, cfg, msa, z, rng=rm, **kw)
        z_out = pair_branch(p, cfg, z, rng=rz, **kw)
        return msa_out, z_out + opm_apply(p.opm, cfg, msa_out, row_mask=row_mask)
    raise ValueError(f"unknown Evoformer variant {cfg.variant!r}")
