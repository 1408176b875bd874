"""Mamba2 (SSD, state-space duality, arXiv:2405.21060): counterpart of
``repro/models/ssm.py``, the partition rules (``partition_rules``)
included.

Scalar decay per head: S_t = exp(dt_t A_h) S_{t-1} + dt_t B_t x_t^T;
y_t = C_t S_t + D_h x_t.  ``ssd_chunked`` is the chunked form (intra-chunk
quadratic term plus a scan over chunk states), ``ssd_reference`` the
token-by-token recurrence, ``ssd_decode_step`` one token.

The reference writes its functions for one sequence and vmaps them over the
batch; here every function takes any leading batch dims (``x`` (..., T, H,
P)).  ``BF16.cast`` casts every floating parameter, ``A_log``, ``dt_bias``
and ``D`` included, as the reference's cast does: A = -exp(A_log) is bf16
in serving and its products with the fp32 dt promote to fp32.

``prefill`` takes each sequence's final state S from the chunked pass (the
last chunk's entering state times that chunk's decay, plus the chunk's own
summary; pad steps have dt 0 and are inert), where the reference rebuilds
it by a scan over every prompt token: the same sum in another order.
``prefill`` and ``decode_step`` write the cache's tensors in place.

Under tensor parallelism (``parallel.tensor``) a rank holds its heads'
columns of ``wz`` / ``wx`` / ``wdt``, its heads of ``dt_bias`` /
``A_log`` / ``D`` and its rows of ``out``; ``wB`` / ``wC`` and
``conv_w`` are replicated.  B and C are computed whole on every rank
(their convolution too) and read through ``tensor.copy_in`` by the
rank's heads; the rank reads its own x channels of ``conv_w`` and of
``gate_ln``'s scale through ``copy_in`` as well.  The gated RMSNorm
spans the whole ``d_inner``: its sum of squares is ``psum``-ed over
``model`` (a sum whose every rank uses it for its own columns, so the
backward sums too).  A cache's ``conv`` holds the rank's x channels and
the whole B and C (the cache rule would cut the concatenated channels
evenly; ROADMAP "Reference caveats" lists the bytes), ``S`` the rank's
heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.dense import remat
from repro_torch.models.lmconfig import LMConfig
from repro_torch.nn.partition import P
from repro_torch.nn.layers import (Dense, Embedding, Policy, RMSNorm, dense,
                                   drawn, rmsnorm, make_generator)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import tensor

BF16 = Policy()


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_reference(x, dt, A, B, C, D):
    """The recurrence, token by token.  x (..., T, H, P), dt (..., T, H),
    A (H,), B/C (..., T, N), D (H,) -> y (..., T, H, P) in fp32."""
    *lead, t, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    S = torch.zeros((*lead, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(t):
        S, y = _ssd_step(S, xf[..., i, :, :], dtf[..., i, :], A,
                         Bf[..., i, :], Cf[..., i, :])
        ys.append(y)
    return torch.stack(ys, dim=-3) + xf * D[:, None]


def _ssd_step(S, x1, dt1, A, B1, C1):
    """S (..., H, N, P), x1 (..., H, P), dt1 (..., H), B1/C1 (..., N), all
    fp32 but A -> (S', C1 . S')."""
    decay = torch.exp(dt1 * A)
    S = S * decay[..., None, None] + torch.einsum(
        "...n,...hp->...hnp", B1, x1 * dt1[..., None])
    return S, torch.einsum("...n,...hnp->...hp", C1, S)


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int, return_state: bool = False):
    """Chunked SSD, ``ssd_reference``'s signature and semantics (fp32 out).
    ``return_state``: also return the state after the last token, S (...,
    H, N, P) fp32."""
    *lead, t0, h, p = x.shape
    n = B.shape[-1]
    t = t0
    if t % chunk:
        # pad with dt = 0 steps: decay exp(0) = 1, contribution dt x = 0
        pad = chunk - t % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        t += pad
    nc = t // chunk
    xf = x.float().reshape(*lead, nc, chunk, h, p)
    dtc = dt.float().reshape(*lead, nc, chunk, h)
    Bc = B.float().reshape(*lead, nc, chunk, n)
    Cc = C.float().reshape(*lead, nc, chunk, n)

    a_cum = torch.cumsum(dtc * A, dim=-2)                 # (..., nc, Q, H)
    xbar = xf * dtc[..., None]                            # dt-weighted input

    # intra-chunk: Y[i] = sum_{j<=i} exp(acum_i - acum_j) (C_i.B_j) xbar_j
    scores = torch.einsum("...cin,...cjn->...cij", Cc, Bc)
    logdec = a_cum[..., :, None, :] - a_cum[..., None, :, :]  # (.., i, j, H)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    decay = torch.where(mask[:, :, None], torch.exp(logdec), 0.0)
    att = scores[..., None] * decay
    y_intra = torch.einsum("...cijh,...cjhp->...cihp", att, xbar)

    # chunk summary states: S_c = sum_j exp(acum_last - acum_j) B_j xbar_j^T
    w = torch.exp(a_cum[..., -1:, :] - a_cum)             # (..., nc, Q, H)
    S_chunk = torch.einsum("...cjn,...cjhp->...chnp", Bc, xbar * w[..., None])

    # inter-chunk scan: S_c = S_{c-1} exp(acum_last_c) + S_chunk_c
    chunk_decay = torch.exp(a_cum[..., -1, :])            # (..., nc, H)
    S = torch.zeros((*lead, h, n, p), dtype=torch.float32, device=x.device)
    S_prev = []
    for c in range(nc):
        S_prev.append(S)
        S = S * chunk_decay[..., c, :, None, None] + S_chunk[..., c, :, :, :]
    S_prev = torch.stack(S_prev, dim=-4)                  # (..., nc, H, N, P)

    # inter contribution: y[i] += C_i (exp(acum_i) S_prev)
    y_inter = torch.einsum("...cin,...chnp->...cihp", Cc, S_prev) \
        * torch.exp(a_cum)[..., None]
    y = (y_intra + y_inter).reshape(*lead, t, h, p)[..., :t0, :, :]
    y = y + x[..., :t0, :, :].float() * D[:, None]
    return (y, S) if return_state else y


def ssd_decode_step(S, x1, dt1, A, B1, C1, D):
    """One token's state update.  S (..., H, N, P) fp32, x1 (..., H, P),
    dt1 (..., H), B1/C1 (..., N); returns (S', y (..., H, P) fp32)."""
    x1 = x1.float()
    S, y = _ssd_step(S, x1, dt1.float(), A, B1.float(), C1.float())
    return S, y + x1 * D[:, None]


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One Mamba2 block under the reference's names: the separate
    projections ``wz`` / ``wx`` / ``wB`` / ``wC`` / ``wdt``, ``dt_bias``
    (softplus^-1 of linspace(0.001, 0.1)), ``A_log`` (log linspace(1, 16)),
    ``D`` (ones), ``conv_w`` (K, d_inner + 2N) of 0.1 N(0, 1), ``gate_ln``
    and ``out``."""

    def __init__(self, cfg: LMConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        d, di, h, n = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_state
        kw = dict(generator=generator, use_bias=False, device=device)
        self.ln = RMSNorm(d, device=device)
        self.wz = Dense(d, di, **kw)
        self.wx = Dense(d, di, **kw)
        self.wB = Dense(d, n, **kw)
        self.wC = Dense(d, n, **kw)
        self.wdt = Dense(d, h, **kw)
        lin = lambda a, b: torch.linspace(a, b, h, dtype=torch.float32,
                                          device=device)
        self.dt_bias = nn.Parameter(            # softplus^-1
            torch.log(torch.exp(lin(0.001, 0.1)) - 1.0))
        self.A_log = nn.Parameter(torch.log(lin(1.0, 16.0)))
        self.D = nn.Parameter(torch.ones((h,), device=device))
        conv_w = torch.empty((cfg.ssm_conv, di + 2 * n), device=device)
        if not conv_w.is_meta:
            conv_w = 0.1 * torch.randn(conv_w.shape, generator=generator,
                                       device=device)
        self.conv_w = nn.Parameter(conv_w)
        self.gate_ln = RMSNorm(di, device=device)
        self.out = Dense(di, d, **kw)


def _causal_conv(u, w, *, state=None):
    """Depthwise causal conv1d.  u (..., T, C), w (K, C), state (..., K-1,
    C) the history.  Returns (out, the last K-1 rows of history + u)."""
    k, t = w.shape[0], u.shape[-2]
    if state is None:
        pad = u.new_zeros((*u.shape[:-2], k - 1, u.shape[-1]))
    else:
        pad = state.to(u.dtype)
    ext = torch.cat([pad, u], dim=-2)                     # (..., T+K-1, C)
    out = ext[..., 0:t, :] * w[0]
    for i in range(1, k):
        out = out + ext[..., i:i + t, :] * w[i]
    return out, ext[..., ext.shape[-2] - (k - 1):, :]


def inner_cols(p: Block, cfg: LMConfig):
    """This rank's range of the ``d_inner`` columns (its heads'; None:
    all), checked against ``wdt``'s heads."""
    cols = tensor.split_of(p.wx.w.shape[-1], cfg.d_inner, "wx")
    heads = tensor.split_of(p.wdt.w.shape[-1], cfg.n_ssm_heads, "wdt")
    if (cols is None) != (heads is None) or (
            cols is not None and cols[0] != heads[0] * cfg.ssm_head_dim):
        raise ValueError(f"wx columns {cols} do not hold wdt's heads "
                         f"{heads}")
    return cols


def _mixer_inputs(p: Block, cfg: LMConfig, x):
    """The block's projections of x (..., T, D): z, dt (fp32), and xbc =
    [x | B | C] before the convolution (this rank's x channels)."""
    h_ = rmsnorm(p.ln, x)
    hf = h_ if inner_cols(p, cfg) is None else tensor.copy_in(h_)
    z = dense(p.wz, hf)
    xbc = torch.cat([dense(p.wx, hf), dense(p.wB, h_), dense(p.wC, h_)], -1)
    dt = F.softplus(dense(p.wdt, hf).float() + p.dt_bias)
    return z, dt, xbc


def _conv_weight(p: Block, cfg: LMConfig, dtype):
    """``conv_w`` over this rank's x channels and the whole B and C."""
    w, cols = p.conv_w, inner_cols(p, cfg)
    if cols is not None:
        di = cfg.d_inner
        w = torch.cat([tensor.narrow(tensor.copy_in(w[:, :di]), 1, cols),
                       w[:, di:]], 1)
    return w.to(dtype)


def _split_xbc(cfg: LMConfig, xbc):
    """(x heads (..., H, P), B, C) of the convolved channels; B and C,
    whole on every rank, read by this rank's heads."""
    n = cfg.ssm_state
    di = xbc.shape[-1] - 2 * n
    xin = xbc[..., :di]
    xh = xin.reshape(*xin.shape[:-1], di // cfg.ssm_head_dim,
                     cfg.ssm_head_dim)
    Bp, Cp = xbc[..., di:di + n], xbc[..., di + n:]
    if di != cfg.d_inner:
        Bp, Cp = tensor.copy_in(Bp), tensor.copy_in(Cp)
    return xh, Bp, Cp


def _gated_out(p: Block, cfg: LMConfig, y, z, dtype, *, eps: float = 1e-6):
    """rmsnorm(y * silu(z)) through ``out``; y (..., T, d_inner) fp32 (this
    rank's columns: the norm's sum of squares summed over ``model``)."""
    y = y.to(dtype)
    cols = inner_cols(p, cfg)
    if cols is None:
        return dense(p.out, rmsnorm(p.gate_ln, y * F.silu(z)))
    g = (y * F.silu(z)).float()
    ss = coll.psum(g.square().sum(-1, keepdim=True), tensor.current())
    scale = tensor.narrow(tensor.copy_in(p.gate_ln.scale), 0, cols)
    n = (g * torch.rsqrt(ss / cfg.d_inner + eps) * scale.float()).to(dtype)
    return tensor.row_dense(p.out, n, cfg.d_inner, "out")


def mamba_with_state(p: Block, cfg: LMConfig, x, *, chunked: bool = True):
    """The block on x (..., T, D) -> (out (..., T, D), (conv state: the last
    K-1 rows of xbc before the convolution (fewer when T < K-1), S (..., H,
    N, P) fp32 after the last token, or None for ``chunked=False``))."""
    t = x.shape[-2]
    z, dt, xbc = _mixer_inputs(p, cfg, x)
    conv_state = xbc[..., max(t - (cfg.ssm_conv - 1), 0):, :]
    u, _ = _causal_conv(xbc, _conv_weight(p, cfg, xbc.dtype))
    xh, Bp, Cp = _split_xbc(cfg, F.silu(u))
    A = -torch.exp(p.A_log)
    if chunked:
        y, S = ssd_chunked(xh, dt, A, Bp, Cp, p.D,
                           chunk=min(cfg.ssm_chunk, t), return_state=True)
    else:
        y, S = ssd_reference(xh, dt, A, Bp, Cp, p.D), None
    y = y.reshape(*y.shape[:-2], -1)
    return _gated_out(p, cfg, y, z, x.dtype), (conv_state, S)


def block_apply(p: Block, cfg: LMConfig, x, *, chunked: bool = True):
    """x (..., T, D) -> (..., T, D)."""
    return mamba_with_state(p, cfg, x, chunked=chunked)[0]


def check_prompt(cfg: LMConfig, t: int) -> None:
    """A prefill keeps the last K-1 inputs of the convolution as its
    history, so a prompt needs at least K-1 tokens: the reference's prefill
    keeps ``xbc[-(K-1):]`` of a shorter one, whose short history its cache
    cannot take."""
    if t < cfg.ssm_conv - 1:
        raise ValueError(f"a prompt of {t} tokens is shorter than the "
                         f"convolution's history of {cfg.ssm_conv - 1} "
                         f"(ssm_conv - 1): prefill needs at least that many")


def block_decode(p: Block, cfg: LMConfig, x1, state):
    """x1 (..., D), state {"conv": (..., K-1, C), "S": (..., H, N, P)} ->
    (y (..., D), new state)."""
    z, dt, xbc = _mixer_inputs(p, cfg, x1[..., None, :])
    xbc, conv_state = _causal_conv(xbc, _conv_weight(p, cfg, xbc.dtype),
                                   state=state["conv"])
    xh, Bp, Cp = _split_xbc(cfg, F.silu(xbc)[..., 0, :])
    A = -torch.exp(p.A_log)
    S, y = ssd_decode_step(state["S"], xh, dt[..., 0, :], A, Bp, Cp, p.D)
    y = _gated_out(p, cfg, y.reshape(*y.shape[:-2], -1)[..., None, :], z,
                   x1.dtype)
    return y[..., 0, :], {"conv": conv_state, "S": S}


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class MambaLM(nn.Module):
    """All parameters, drawn on ``device`` (``cuda`` by default, raising
    without a card unless ``device="cpu"``) from a generator there seeded
    with ``seed``, one module at a time, each cast to ``dtype`` as soon as
    it is drawn (as ``dense.DenseLM``)."""

    def __init__(self, cfg: LMConfig, *, seed: int = 0, device=None,
                 dtype: torch.dtype = torch.float32, cut=None):
        super().__init__()
        device = resolve_device(device)
        g = make_generator(device, seed)
        kw = dict(generator=g, device=device)
        self.embed = drawn(Embedding(cfg.vocab, cfg.d_model, **kw), dtype,
                           cut, "embed.")
        self.layers = nn.ModuleList(
            drawn(Block(cfg, **kw), dtype, cut, f"layers.{i}.")
            for i in range(cfg.n_layer))
        self.ln_f = drawn(RMSNorm(cfg.d_model, device=device), dtype, cut,
                          "ln_f.")
        self.lm_head = drawn(Dense(cfg.d_model, cfg.vocab, use_bias=False,
                                   **kw), dtype, cut, "lm_head.")


def init_params(cfg: LMConfig, *, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32, cut=None) -> MambaLM:
    return MambaLM(cfg, seed=seed, device=device, dtype=dtype, cut=cut)


def backbone(params: MambaLM, cfg: LMConfig, x, positions=None, *,
             chunked: bool = True):
    """The block stack on embeddings x (B, T, D), each block under
    ``dense.remat``, then ``ln_f`` (``positions`` is unused: the blocks
    read order from the recurrence)."""
    def one(lp, x):
        return (x + block_apply(lp, cfg, x, chunked=chunked)).to(x.dtype)

    one = remat(cfg, one)
    for lp in params.layers:
        x = one(lp, x)
    return rmsnorm(params.ln_f, x)


def forward(params: MambaLM, cfg: LMConfig, tokens, *, chunked: bool = True):
    """tokens (B, T) -> logits (B, T, V), in bf16."""
    params = BF16.cast_train(params)
    x = tensor.embed(params.embed.table, tokens, cfg.vocab)
    return tensor.lm_logits(backbone(params, cfg, x, chunked=chunked),
                            params.lm_head.w, cfg.vocab)


def loss(params: MambaLM, cfg: LMConfig, batch: dict):
    logits = forward(params, cfg, batch["tokens"])
    return tensor.cross_entropy(logits, batch["labels"], cfg.vocab,
                                mask=batch.get("mask"))


# serving: a recurrent state instead of a KV cache, O(1) a decode step

def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    device = resolve_device(device)
    c = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((cfg.n_layer, batch, cfg.ssm_conv - 1, c),
                            dtype=dtype, device=device),
        "S": torch.zeros((cfg.n_layer, batch, cfg.n_ssm_heads, cfg.ssm_state,
                          cfg.ssm_head_dim), dtype=torch.float32,
                         device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def prefill(params: MambaLM, cfg: LMConfig, tokens, cache):
    """Run the chunked form over the prompt tokens (B, T), at least K - 1
    of them, writing each layer's final (conv, S) state into the cache;
    returns (last-token logits (B, 1, V), cache)."""
    b, t = tokens.shape
    check_prompt(cfg, t)
    params = BF16.cast(params)
    x = tensor.embed(params.embed.table, tokens, cfg.vocab)
    for i, lp in enumerate(params.layers):
        y, (conv_s, S) = mamba_with_state(lp, cfg, x)
        x = (x + y).to(x.dtype)
        cache["conv"][i] = conv_s
        cache["S"][i] = S
    x = rmsnorm(params.ln_f, x)
    logits = tensor.lm_logits(x[:, -1:], params.lm_head.w, cfg.vocab)
    return logits, {"conv": cache["conv"], "S": cache["S"],
                    "length": torch.full((b,), t, dtype=torch.int32,
                                         device=x.device)}


@torch.no_grad()
def decode_step(params: MambaLM, cfg: LMConfig, tokens1, cache):
    """One decode step: tokens1 (B, 1) -> (logits (B, 1, V), cache)."""
    params = BF16.cast(params)
    x = tensor.embed(params.embed.table, tokens1, cfg.vocab)[:, 0]  # (B, D)
    for i, lp in enumerate(params.layers):
        y, st = block_decode(lp, cfg, x, {"conv": cache["conv"][i],
                                          "S": cache["S"][i]})
        x = (x + y).to(x.dtype)
        cache["conv"][i] = st["conv"]
        cache["S"][i] = st["S"]
    x = rmsnorm(params.ln_f, x)
    logits = tensor.lm_logits(x[:, None], params.lm_head.w, cfg.vocab)
    return logits, {"conv": cache["conv"], "S": cache["S"],
                    "length": cache["length"] + 1}


# ---------------------------------------------------------------------------
# partitioning
# ---------------------------------------------------------------------------

def partition_rules(cfg: LMConfig, *, tp_axis="model", fsdp_axis="data"):
    fs = fsdp_axis if cfg.fsdp else None
    lay = ((lambda *sp: P(None, *sp)) if cfg.scan_layers else
           (lambda *sp: P(*sp)))
    return [
        (r"embed/table", P(tp_axis, fs)),
        (r"lm_head/w", P(fs, tp_axis)),
        (r"w[zx]/w", lay(fs, tp_axis)),       # heads shard
        (r"w[BC]/w", lay(fs, None)),          # group-shared: replicate
        (r"wdt/w", lay(fs, tp_axis)),
        (r"(dt_bias|A_log|D)$", lay(tp_axis)),
        (r"conv_w", lay(None, None)),
        (r"out/w", lay(tp_axis, fs)),
        (r"ln", P()),
    ]
