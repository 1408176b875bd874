#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (exit code != 0, no result line):
  1. device: the card's name and power limit (nvidia-smi); TF32 off.
  2. build: every CUDA source under src/repro_torch/csrc with nvcc, in
     parallel, into build/repro_torch_kernels.
  3. kernels: each hand-written kernel against its plain PyTorch version at
     every shape the serving path gives it, in every bucket of the engine's
     af2_initial table, plus ragged shapes; max |diff| and the least atol
     the check passes with, kernel / plain / library times (CUDA events)
     and the bound.
  4. small fold: an af2_tiny fold through the kernels on the card against
     the same fold on the CPU through the plain versions, fp32 and bf16.
  5. main path: FoldEngine at af2_initial width and depth (48 + 4 blocks,
     c_m 256, c_z 128, largest bucket r 256 s 128 se 1024), seeded random
     weights, 4 requests over 2 buckets, micro-batch 2, 3 recycles; the
     kernels' launch counters must equal what the path implies.  Served
     eagerly (graphs=False), then by a graphed engine twice: the first run
     captures each bucket's sample-cycle, the second only replays (its
     launches counted through replay credits); walls, folds/s, per-step
     latency, peak memory, compile_misses, and the graphed-vs-eager max
     |diff| of coordinates and pLDDT.
  6. profile: one more largest-bucket step of each engine, eager and
     graphed, plain and under torch.profiler (device busy time, idle share,
     host launch calls, time by kernel family; K1 and K3 must show in
     both).
  7. training kernels: K1 with its log-sum-exp, K2, K3 with its fp32 s, K4
     and K5 against their plain versions at every shape the af2_initial
     training step gives them, plus ragged shapes (S 100, r 100) and K2 at
     S 1000 with a bias, in bf16
     and at one fp32 shape each; max |diff| and the least atol each check
     passes with, kernel / plain / library times and the bound (K2's
     library time: SDPA's autograd backward with its backend pinned,
     printed with each K2 row beside K2's GB/s; K4, which no single call
     computes, prints beside its null library time the time of the six
     bf16 torch.matmul products it contains, as a products-only yardstick).
  8. small train step: af2_tiny loss and every parameter gradient on the
     card (kernels K1-K5) against the CPU (their plain versions), fp32 and
     bf16.
  9. training main path: TrainRunner at af2_initial width and depth (48 + 4
     blocks, r 256 s 128 se 1024), batch 1, its defaults (AdamW, per-sample
     clipping, EMA, stochastic recycling 1..4, dropout, remat="block"), one
     warm-up step then 3 steps; finite losses and gradient norms, changed
     parameters and EMA, launch counters equal to what each step's drawn
     n_recycle implies; then one more step under torch.profiler.
 10. LM kernel: K6 (causal GQA flash attention) against its plain version at
     every shape the glm4-9b serving path gives it (prompts 512, 1000, 2048,
     3000), plus non-causal, T != S, ragged, fp32 and head dims 32 / 64.
 11. LM main path: glm4-9b at full width and depth (40 layers, d 4096, 32
     heads over 2 KV heads, vocab 151552), seeded random bf16 weights drawn
     on the card, DecodeEngine with 4 slots and a 4096-token cache, 8
     requests (prompts 512, 1000, 2048, 3000, twice) of 32 new tokens each;
     every request gets 32 token ids in the vocabulary, K6 launches 40 x 8
     times and no other kernel launches; for two requests served in slots
     1 and 3 beside live slots, the logits the engine took each of their
     tokens from (prefill, then the batched decode steps on the slot-copied
     cache) lie no farther from the plain path's fp32 value on prompt +
     tokens than 1.5x the plain bf16 path's; prefill and decode tokens/s,
     time to first token, decode step latency, peak memory.  Served by an
     eager engine, then by a graphed one (its decode step and each prompt
     length's prefill captured in a warm-up first), both held to the same
     checks, with compile_misses, whether every token id agrees and the
     max |diff| of the checked logits; then one prefill (S 2048) and one
     decode step under torch.profiler, eager and as graph replays.
Kernel and library times are medians of 5 timed repeats, each after a
warm-up call, printed with their min-max spread.  Then one JSON line of
kernel figures, the nvidia-smi line, and the result line ``{"ok": true,
"device": {...}}`` last.
"""
import collections
import copy
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 outside
# the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# kernel vs plain version: |diff| <= ATOL + RTOL * |plain|, bf16 outputs
# (the reference's bf16 tolerance, plus one bf16 ulp relative)
ATOL, RTOL = 3e-2, 2.0 ** -7
# K6's bf16 outputs are means over up to 3000 keys of N(0, 1) values, |out|
# ~0.03-0.05 at the glm4-9b prompt lengths, where ATOL would be as large as
# the values.  RTOL covers one ulp of the output's rounding; K6_ATOL the
# rounding of p to bf16 against a running max instead of the row's max
# (each K6 row prints the least atol it passes with).
K6_ATOL = 2e-3
# K2's yardstick: SDPA's autograd backward on this backend only (unpinned,
# the dispatcher's choice moved its time 93.7-111.0 ms between runs)
K2_LIBRARY_BACKEND = SDPBackend.EFFICIENT_ATTENTION


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_time(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call over ``iters`` calls, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


REPEATS = 5


def cuda_median(fn, iters: int, repeats: int = REPEATS):
    """(median, min, max) over ``repeats`` timed runs of the mean ms per call
    of ``iters`` calls, each run after a warm-up call.  Kernel and library
    times use it: one run's yardstick moved 2.6x between calls."""
    runs = sorted(cuda_time(fn, iters, warmup=1) for _ in range(repeats))
    return runs[len(runs) // 2], runs[0], runs[-1]


def add_timed(tot: dict, key: str, per: float, stats) -> None:
    """Add ``per`` times the median of a (median, min, max) to ``tot[key]``,
    and ``per`` times its min and max to ``tot[key + "_spread"]`` (sums of
    the shapes' spreads: no run timed the total itself)."""
    tot[key] = tot.get(key, 0.0) + per * stats[0]
    spread = tot.setdefault(key + "_spread", [0.0, 0.0])
    spread[0] += per * stats[1]
    spread[1] += per * stats[2]


def timed_fields(key: str, stats) -> dict:
    return {key: stats[0], key + "_spread": [stats[1], stats[2]]}


def check_close(got, want, what: str, atol=ATOL, rtol=RTOL) -> float:
    d = (got.float() - want.float()).abs()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    excess = (d - atol - rtol * want.float().abs()).max().item()
    err = d.max().item()
    if excess > 0:
        raise AssertionError(f"{what}: max |diff| {err} over tolerance "
                             f"(atol {atol}, rtol {rtol})")
    return err


def atol_needed(got, want, rtol, extra=0.0) -> float:
    """The least atol with which |got - want| <= atol + rtol |want| (+
    ``extra``) holds: how much of a check's atol a kernel uses."""
    return ((got.float() - want.float()).abs() - rtol * want.float().abs()
            - extra).max().item()


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def path_shapes(cfg):
    """Every shape the serving path gives K1 and K3, for each bucket of the
    engine's table, plus ragged shapes.  K1 rows: (name, bucket r, (L, S, H,
    C), launches per sample-cycle, masked); K3 rows: (name, bucket r, r,
    outgoing, launches per sample-cycle, masked).  Launch counts are those
    of the largest bucket (the kernel totals' unit), 0 elsewhere."""
    from repro_torch.serve import fold_steps as fs
    ev, ex = cfg.evoformer, cfg.extra
    buckets = fs.default_buckets(cfg)
    top = max(buckets)
    k1, k3 = {}, []
    for b in buckets:
        r, s, se = b.n_res, b.n_seq, b.n_extra_seq
        n = (lambda c: c) if b == top else (lambda c: 0)
        for name, shape, per in (
                ("msa_row", (s, r, ev.n_head_msa, ev.c_hidden_att),
                 cfg.n_evoformer),
                ("msa_col", (r, s, ev.n_head_msa, ev.c_hidden_att),
                 cfg.n_evoformer),
                ("triangle_start_end", (r, r, ev.n_head_pair,
                                        ev.c_hidden_pair_att),
                 2 * cfg.n_evoformer),
                ("extra_triangle_start_end", (r, r, ex.n_head_pair,
                                              ex.c_hidden_pair_att),
                 2 * cfg.n_extra_msa_blocks),
                ("extra_row", (se, r, ex.n_head_msa, ex.c_hidden_att),
                 cfg.n_extra_msa_blocks)):
            key = (r, shape)            # launches of one shape (both stacks'
            if key in k1:               # triangle attention): one row, summed
                k1[key][0] += "+" + name
                k1[key][2] += n(per)
            else:
                k1[key] = [name, r, n(per), True]
        for outgoing in (True, False):
            k3.append(("outgoing" if outgoing else "incoming", r, r,
                       outgoing, n(cfg.n_evoformer + cfg.n_extra_msa_blocks),
                       True))
    k1 = [(name, r, shape, per, masked)
          for (_, shape), (name, r, per, masked) in k1.items()]
    k1 += [("ragged_masked", None, (64, 100, 4, 32), 0, True),
           ("ragged_nobias", None, (64, 100, 4, 32), 0, False)]
    k3 += [("ragged_masked_incoming", None, 100, False, 0, True),
           ("ragged_unmasked_outgoing", None, 100, True, 0, False)]
    return k1, k3


def check_evo_attention(dev, shapes):
    from repro_torch.kernels import evo_attention as ka
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(0)
    rows, tot = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                     "bound_ms": 0.0, "flops": 0.0, "bytes": 0.0}
    errs = []
    for name, bucket_r, (L, S, H, C), per_cycle, masked in shapes:
        mk = lambda: torch.randn((L, S, H, C), device=dev, generator=g).to(torch.bfloat16)
        q, k, v, gate = mk(), mk(), mk(), mk()
        bias = None
        if masked:   # pair bias with a key mask folded in, as serving does
            bias = torch.randn((H, S, S), device=dev, generator=g)
            bias[:, :, S - S // 5:] = -1e9
        got = ka.evo_attention_fwd(q, k, v, bias, gate)
        want = ref.evo_attention_ref(q, k, v, bias, gate)
        torch.cuda.synchronize()
        err = check_close(got, want, f"evo_attention {name}")
        needed = atol_needed(got, want, RTOL)
        errs.append(err)
        iters = 20 if L * S * S * H < 2 ** 27 else 5
        ms = cuda_median(lambda: ka.evo_attention_fwd(q, k, v, bias, gate), iters)
        plain_ms = cuda_time(lambda: ref.evo_attention_ref(q, k, v, bias, gate), 3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # (L, H, S, C)
        mask = None if bias is None else bias.to(torch.bfloat16)
        lib_ms = cuda_median(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), iters)
        flops = 4.0 * L * H * S * S * C
        nbytes = 5 * L * S * H * C * 2 + (H * S * S * 4 if masked else 0)
        b_ms, b_by = bound(flops, nbytes)
        rows.append(dict(shape=name, bucket_r=bucket_r, L=L, S=S, H=H, C=C,
                         masked=masked, per_cycle=per_cycle,
                         max_abs_err=err, atol=ATOL, atol_needed=needed,
                         **timed_fields("ms", ms),
                         plain_ms=plain_ms, **timed_fields("library_ms", lib_ms),
                         bound_ms=b_ms, bound_by=b_by))
        add_timed(tot, "ms", per_cycle, ms)
        add_timed(tot, "library_ms", per_cycle, lib_ms)
        for key, val in (("plain_ms", plain_ms), ("bound_ms", b_ms),
                         ("flops", flops), ("bytes", nbytes)):
            tot[key] += per_cycle * val
        del q, k, v, gate, bias, got, want
    return rows, tot, max(errs)


def check_triangle(dev, shapes, c_z: int, c: int):
    from repro_torch.kernels import ref
    from repro_torch.kernels import triangle as kt
    g = torch.Generator(device=dev).manual_seed(1)
    rows, tot = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                     "bound_ms": 0.0, "flops": 0.0, "bytes": 0.0}
    errs = []
    for name, bucket_r, r, outgoing, per_cycle, masked in shapes:
        rn = lambda *s, scale=1.0: (scale * torch.randn(
            s, device=dev, generator=g)).to(torch.bfloat16)
        x = rn(r, r, c_z)
        w = (rn(c_z, 2 * c, scale=c_z ** -0.5), rn(2 * c, scale=0.5),
             rn(c_z, 2 * c, scale=c_z ** -0.5), rn(2 * c, scale=0.5),
             1 + rn(c, scale=0.1), rn(c, scale=0.1),
             rn(c, c_z, scale=c ** -0.5), rn(c_z, scale=0.1),
             rn(c_z, c_z, scale=c_z ** -0.5), rn(c_z, scale=0.5))
        xab = x if outgoing else x.transpose(0, 1)
        km = None
        if masked:
            km = torch.ones(r, device=dev)
            km[r - r // 5:] = 0.0
        got = kt.triangle_mult_fwd(xab, xab, x, *w, k_mask=km)
        want = ref.triangle_mult_ref(xab, xab, x, *w, k_mask=km)
        torch.cuda.synchronize()
        err = check_close(got, want, f"triangle_mult {name}")
        needed = atol_needed(got, want, RTOL)
        errs.append(err)
        ms = cuda_median(lambda: kt.triangle_mult_fwd(xab, xab, x, *w, k_mask=km), 10)
        plain_ms = cuda_time(lambda: ref.triangle_mult_ref(xab, xab, x, *w, k_mask=km), 3)
        a = ref.gated_projection(xab, w[0], w[1]).to(torch.bfloat16)
        lib_ms = cuda_median(lambda: torch.einsum("ikc,jkc->ijc", a, a), 10)
        flops = (2 * 2.0 * r * r * c_z * 2 * c     # gated projections a, b
                 + 2.0 * r ** 3 * c                # k-contraction
                 + 2.0 * r * r * c * c_z           # out-projection
                 + 2.0 * r * r * c_z * c_z)        # gate projection
        # x is the one activation input (xa, xb, xg all view it)
        nbytes = (2 * r * r * c_z * 2 + sum(t.numel() * 2 for t in w)
                  + (r * 4 if masked else 0))
        b_ms, b_by = bound(flops, nbytes)
        rows.append(dict(shape=name, bucket_r=bucket_r, r=r, c_z=c_z, c=c,
                         masked=masked, per_cycle=per_cycle,
                         max_abs_err=err, atol=ATOL, atol_needed=needed,
                         **timed_fields("ms", ms),
                         plain_ms=plain_ms, **timed_fields("library_ms", lib_ms),
                         bound_ms=b_ms, bound_by=b_by))
        add_timed(tot, "ms", per_cycle, ms)
        add_timed(tot, "library_ms", per_cycle, lib_ms)
        for key, val in (("plain_ms", plain_ms), ("bound_ms", b_ms),
                         ("flops", flops), ("bytes", nbytes)):
            tot[key] += per_cycle * val
        del x, w, xab, got, want, a
    return rows, tot, max(errs)


# ---------------------------------------------------------------------------
# Phases 4 and 5: folds
# ---------------------------------------------------------------------------

def seeded_model(cfg, seed: int, noise: float = 0.02):
    """The port's seeded init with every parameter perturbed by N(0, noise)
    (AF2 zero-inits its residual output layers; unperturbed, no kernel's
    output would reach the result)."""
    from repro_torch.core.model import AlphaFold2
    model = AlphaFold2(cfg, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(noise * torch.randn(p.shape, generator=g))
    return model


def small_fold_check(dev):
    """af2_tiny fold, padded batch of 2, on the card (kernels) and on the CPU
    (plain versions).  fp32: the card equals the CPU within 1e-3 (CUDA-core
    kernels).  bf16 (tensor-core kernels): the card's fold may stray from the
    CPU's fp32 fold at most 3x as far as the CPU's own bf16 fold does — bf16
    rounding noise, where a wrong kernel moves coordinates by O(1).
    Returns (fp32 |diff|, bf16 card |diff|, bf16 CPU |diff|)."""
    from repro_torch.core import model as af2
    from repro_torch.core.config import af2_tiny, with_kernels
    from repro_torch.data.synthetic import make_fold_requests
    from repro_torch.serve import fold_steps as fs
    cfg = with_kernels(af2_tiny())
    model = seeded_model(cfg, seed=3, noise=0.1)
    on_card = copy.deepcopy(model).to(dev)
    reqs = make_fold_requests(cfg, 2, seed=3, fracs=(1.0, 0.7))
    bucket = fs.Bucket(cfg.n_res, cfg.n_seq, cfg.n_extra_seq)
    batch = fs.stack_padded([fs.pad_to_bucket(r.features, bucket)
                             for r in reqs], 2)

    def coords(m, dtype):
        return af2.predict(m, cfg, batch, max_recycle=2, tol=0.0,
                           dtype=dtype)["coords"].float().cpu()

    cpu32 = coords(model, torch.float32)
    err32 = (coords(on_card, torch.float32) - cpu32).abs().max().item()
    if not (err32 < 1e-3 and cpu32.abs().max().item() > 0.1):
        raise AssertionError(f"af2_tiny fp32 fold: card vs CPU max |diff| {err32}")
    err16 = (coords(on_card, torch.bfloat16) - cpu32).abs().max().item()
    noise16 = (coords(model, torch.bfloat16) - cpu32).abs().max().item()
    if not err16 <= 3 * noise16:
        raise AssertionError(f"af2_tiny bf16 fold: card {err16} from the fp32 "
                             f"fold, over 3x the CPU's bf16 {noise16}")
    return err32, err16, noise16


def main_path(cfg, dev, *, graphs: bool, n_requests=4, micro_batch=2,
              max_recycle=3):
    """A FoldEngine (``graphs`` on or off) over the seeded model and the
    main path's ``n_requests`` requests; returns (requests, engine)."""
    from repro_torch.data.synthetic import make_fold_requests
    from repro_torch.serve.fold_engine import FoldEngine
    model = seeded_model(cfg, seed=0)
    engine = FoldEngine(cfg, model, micro_batch=micro_batch,
                        max_recycle=max_recycle, tol=0.0, device=dev,
                        graphs=graphs)
    return make_fold_requests(cfg, n_requests, seed=0), engine


def serve_folds(engine, reqs):
    """One ``engine.run(reqs)`` with the launch counters set to 0 just
    before and read just after; returns (results, launch counts, wall
    seconds, per-step seconds by bucket of this run, peak allocated GiB,
    reserved GiB after the run: it holds the graph pool)."""
    from repro_torch.kernels import ops
    before = {b: dict(v) for b, v in engine.stats["per_bucket"].items()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    step_s = {}
    for b, v in sorted(engine.stats["per_bucket"].items()):
        old = before.get(b, {"steps": 0, "seconds": 0.0})
        if v["steps"] > old["steps"]:
            step_s[b.n_res] = round((v["seconds"] - old["seconds"])
                                    / (v["steps"] - old["steps"]), 4)
    return (done, counts, wall, step_s,
            torch.cuda.max_memory_allocated() / 2 ** 30,
            torch.cuda.memory_reserved() / 2 ** 30)


def fold_report(tag, cfg, done, engine, counts, wall, step_s, peak, reserved,
                sample_cycles):
    print(f"[main path {tag}] af2_initial (48+4 blocks): {len(done)} folds "
          f"over {engine.last_stats['steps']} steps in {wall:.3f}s = "
          f"{len(done) / wall:.3f} folds/s; per-step latency by bucket "
          f"r {step_s} s; {sample_cycles} sample-cycles; compile_misses "
          f"{engine.compile_misses}; peak memory {peak:.2f} GiB allocated, "
          f"{reserved:.2f} GiB reserved; launches {counts}", flush=True)


def check_main_path(cfg, reqs, done, engine, counts, max_recycle=3):
    from repro_torch.serve import fold_steps as fs
    assert sorted(done) == [r.rid for r in reqs], sorted(done)
    buckets = {done[r.rid].bucket for r in reqs}
    assert len(buckets) >= 2, buckets
    sample_cycles = 0
    for r in reqs:
        res = done[r.rid]
        n = fs.request_shapes(r.features)[0]
        assert res.coords.shape == (n, 3) and np.isfinite(res.coords).all()
        assert np.isfinite(res.plddt).all()
        assert res.plddt.min() >= 0.0 and res.plddt.max() <= 100.0
        assert res.n_recycles == max_recycle
        sample_cycles += res.n_recycles
    k1 = 4 * cfg.n_evoformer + 3 * cfg.n_extra_msa_blocks
    k3 = 2 * (cfg.n_evoformer + cfg.n_extra_msa_blocks)
    want = {k: 0 for k in counts}     # serving launches no backward kernel
    want.update(evo_attention_fwd=k1 * sample_cycles,
                triangle_mult_fwd=k3 * sample_cycles)
    assert counts == want, f"launches {counts} != path's {want}"
    return sample_cycles


# ---------------------------------------------------------------------------
# Phase 6: where a main-path step's time goes
# ---------------------------------------------------------------------------

def kernel_family(name: str) -> str:
    """Profile family of a device kernel, by its name: K2, K3, K4 and K5 by
    stage, their fp32 CUDA-core kernels mapped to the same stages (K1 and K6
    are one kernel each)."""
    n = name.lower()
    if "flash_attention_fwd" in n:
        return "K6 flash_attention_fwd"
    if "evo_attention_fwd" in n:
        return "K1 evo_attention_fwd"
    if "evo_bwd_prep" in n or "evo_bwd_bias_pack" in n:
        return "K2 prep (delta, do_raw, dgate; bias copy)"
    if "evo_bwd_dbias_sum" in n or "evo_bwd_dq_sum" in n:
        return "K2 partial sums (dbias; dq past one key window)"
    if "evo_bwd_dq" in n:
        return "K2 dq + dbias"
    if "evo_bwd_dkv" in n:
        return "K2 dk / dv"
    if "tri_proj_f32" in n or "tri_dx_split" in n or "tri_dx_proj" in n:
        return "K5 ds split + gated projections"
    if "tri_dx_contract" in n:
        return "K5 contraction (+ dh)"
    if ("tri_dx_rows" in n or "tri_dx_out" in n or "tri_dx_dw" in n
            or "tri_dx_sums" in n):
        return "K5 dx / dW / db"
    if "tri_epi_dw" in n or "tri_epi_sums" in n:
        return "K4 dW_o / dW_g split-K products and partial sums"
    if "tri_epi" in n:
        return "K4 triangle_mult_bwd_epilogue (per-pair pass)"
    if "outer_acc" in n or "col_sum" in n or "sum_chunks" in n:
        return "K4 / K5 fp32 gradient sums over rows and chunks"
    if "tri_fwd_proj" in n or "tri_proj" in n:
        return "K3 gated projections"
    if "tri_fwd_contract" in n:
        return "K3 contraction"
    if "tri_contract" in n:
        return "K3 contraction + epilogue (fp32)"
    if "tri_fwd_out" in n:
        return "K3 LayerNorm + out-projection + gate"
    if "gemm" in n or "cutlass" in n or "nvjet" in n or "xmma" in n:
        return "GEMM (cuBLAS)"
    return "other (elementwise, reductions, copies)"


def union_ms(spans) -> float:
    """Length of the union of (start, end) microsecond intervals, in ms."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def profile_step(engine, reqs, done, tag):
    """Serve the main path's largest-bucket requests again (warm, same model
    and inputs): once plain, once under torch.profiler (see
    :func:`profile_run`).  Device time must show K1 and K3, inside graph
    replays too."""
    top = max(res.bucket for res in done.values())
    group = [r for r in reqs if done[r.rid].bucket == top]
    by_family = profile_run(lambda: engine.run(group), tag,
                            f"bucket {top.describe()}, {len(group)} requests "
                            f"x {engine.max_recycle} recycles")
    for k in ("K1", "K3"):
        if not any(f.startswith(k) for f in by_family):
            raise AssertionError(f"[profile {tag}] no {k} kernel in the "
                                 f"trace: {sorted(by_family)}")


def profile_run(work, tag: str, what: str) -> dict:
    """Run ``work`` once plain and once under torch.profiler.  Prints both
    walls, the device's busy time (union of kernel intervals) and its idle
    share of the profiled wall, device time by kernel family and the top
    kernels; returns the device ms by family.  The Chrome trace goes to
    build/profile/<tag>_trace.json."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    wall_plain = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = run()
    path = ROOT / "build" / "profile" / f"{tag}_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        raise AssertionError("profiler recorded no device kernels")
    by_name, by_family = {}, {}
    for e in kernels:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
        f = kernel_family(e["name"])
        by_family[f] = by_family.get(f, 0.0) + e["dur"] / 1e3
    busy = union_ms((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    calls = collections.Counter(
        "graph" if "GraphLaunch" in e["name"] else "kernel" for e in events
        if e.get("cat") in ("cuda_runtime", "cuda_driver")
        and "Launch" in e.get("name", ""))
    print(f"[profile {tag}] {what}: wall {wall_plain:.1f} ms plain, "
          f"{wall_prof:.1f} ms under the profiler; device busy {busy:.1f} ms, "
          f"idle share {1 - busy / wall_prof:.3f} of the profiled wall; "
          f"{len(kernels)} kernel launches; host launch calls: "
          f"{calls['kernel']} kernel, {calls['graph']} graph", flush=True)
    for f, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"[profile {tag} family] {ms:10.2f} ms  {ms / busy:6.3f}  {f}")
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:20]:
        print(f"[profile {tag} kernel] {ms:10.2f} ms  {n:6d}  {name[:110]}")
    return by_family


# ---------------------------------------------------------------------------
# Phase 7: the training kernels against their plain versions
# ---------------------------------------------------------------------------

def check_grad_close(got, want, what: str, extra=0.0) -> float:
    """|kernel - plain| <= 1e-4 * max(1, max|plain|) + rtol * |plain|
    (+ ``extra``), rtol 2^-7 for a bf16 output (one ulp either side), 1e-5
    for an fp32 one: both compute in fp32 from the same inputs, in another
    order."""
    if want is None:
        if got is not None:
            raise AssertionError(f"{what}: unexpected output")
        return 0.0
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    rtol = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-5
    atol = 1e-4 * max(1.0, w.abs().max().item())
    d = (g - w).abs()
    if ((d - atol - rtol * w.abs() - extra).max().item()) > 0:
        raise AssertionError(f"{what}: max |diff| {d.max().item()} over "
                             f"tolerance (max |plain| {w.abs().max().item()})")
    return d.max().item()


def grad_margin(got, want, extra=0.0) -> list:
    """[atol needed, atol allowed] of :func:`check_grad_close` for one
    output, at its unchanged rtol."""
    rtol = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-5
    return [atol_needed(got, want, rtol, extra),
            1e-4 * max(1.0, want.abs().max().item())]


def train_shapes(cfg):
    """Shapes the af2_initial training step gives the kernels (full bucket
    r 256, s 128, se 1024; no key masks), with launches per sample-cycle of
    the backward (each forward kernel runs twice as often with its residual:
    forward and remat recompute), plus ragged shapes and a long S with a
    bias (0 per cycle).  K1/K2:
    (name, (L, S, H, C), per cycle, biased); K3/K4/K5: (name, r, outgoing,
    per cycle of K4 (K5 twice that))."""
    ev, ex = cfg.evoformer, cfg.extra
    r, s, se = cfg.n_res, cfg.n_seq, cfg.n_extra_seq
    att = [("msa_row", (s, r, ev.n_head_msa, ev.c_hidden_att), cfg.n_evoformer, True),
           ("msa_col", (r, s, ev.n_head_msa, ev.c_hidden_att), cfg.n_evoformer, False),
           ("triangle_start_end", (r, r, ev.n_head_pair, ev.c_hidden_pair_att),
            2 * (cfg.n_evoformer + cfg.n_extra_msa_blocks), True),
           ("extra_row", (se, r, ex.n_head_msa, ex.c_hidden_att),
            cfg.n_extra_msa_blocks, True),
           ("ragged", (64, 100, 4, 32), 0, True),
           ("ragged_nobias", (64, 100, 4, 32), 0, False),
           ("long_S1000", (2, 1000, 1, 32), 0, True)]
    assert ev.c_hidden_pair_att == ex.c_hidden_pair_att
    assert ev.n_head_pair == ex.n_head_pair
    per = cfg.n_evoformer + cfg.n_extra_msa_blocks
    tri = [("outgoing", r, True, per), ("incoming", r, False, per),
           ("ragged_incoming", 100, False, 0)]
    return att, tri


def _rand(g, shape, dtype, scale=1.0):
    return (scale * torch.randn(shape, device=g.device, generator=g)).to(dtype)


def _tot():
    return {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "flops": 0.0, "bytes": 0.0, "err": 0.0}


def _add(tot, per, ms, plain_ms, lib_ms, b_ms, flops, nbytes, err):
    """``ms`` and ``lib_ms`` are (median, min, max) triples (``lib_ms`` may
    be None: no library call computes the function)."""
    add_timed(tot, "ms", per, ms)
    if lib_ms is not None:
        add_timed(tot, "library_ms", per, lib_ms)
    for key, val in (("plain_ms", plain_ms), ("bound_ms", b_ms),
                     ("flops", flops), ("bytes", nbytes)):
        tot[key] += per * val
    tot["err"] = max(tot["err"], err)


def check_attention_train(dev, shapes, dtype, fp32_shape):
    """K1 with its log-sum-exp and K2, per shape: max |diff| against the
    plain versions, times, bounds.  Returns (rows, {K1-lse, K2} totals per
    sample-cycle of bf16 training)."""
    from repro_torch.kernels import evo_attention as ka
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(7)
    rows, tots = [], {"k1_lse": _tot(), "k2": _tot()}
    runs = [(n, sh, per, b, dtype) for n, sh, per, b in shapes]
    runs.append(("fp32_" + fp32_shape[0], fp32_shape[1], 0, True, torch.float32))
    for name, (L, S, H, C), per, biased, dt in runs:
        el = 2 if dt == torch.bfloat16 else 4
        peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_FP32_FLOPS
        q, k, v, gate, do = (_rand(g, (L, S, H, C), dt) for _ in range(5))
        bias = _rand(g, (H, S, S), dt) if biased else None
        out, lse = ka.evo_attention_fwd(q, k, v, bias, gate, return_lse=True)
        out_r, lse_r = ref.evo_attention_ref(q, k, v, bias, gate, return_lse=True)
        torch.cuda.synchronize()
        err_f = max(check_close(out, out_r, f"K1 {name}"),
                    check_grad_close(lse, lse_r, f"K1 lse {name}"))
        need_f = {"out": [atol_needed(out, out_r, RTOL), ATOL],
                  "lse": grad_margin(lse, lse_r)}
        got = ka.evo_attention_bwd(q, k, v, bias, gate, out_r, lse_r, do)
        want = ref.evo_attention_bwd_ref(q, k, v, bias, gate, out_r, lse_r, do)
        torch.cuda.synchronize()
        # bf16 outputs: dS, P and do_raw are rounded to bf16 as tensor-core
        # operands on both sides, from fp32 values summed in another order,
        # so a few terms may round one ulp apart: one bf16 ulp of the
        # output's largest value on top
        lowp = lambda b: b is not None and b.dtype == torch.bfloat16
        ulp = lambda b: 2.0 ** -7 * max(1.0, b.abs().max().item()) if lowp(b) else 0.0
        outs = list(zip(("dq", "dk", "dv", "dbias", "dgate"), got, want))
        err_b = max(check_grad_close(a, b, f"K2 {name} {n}", ulp(b))
                    for n, a, b in outs)
        need_b = {n: grad_margin(a, b, ulp(b)) for n, a, b in outs
                  if b is not None}
        del got, want, outs
        big = L * S * S * H >= 2 ** 27
        iters = 5 if big else 20
        ms_f = cuda_median(lambda: ka.evo_attention_fwd(
            q, k, v, bias, gate, return_lse=True), iters)
        ms_b = cuda_median(lambda: ka.evo_attention_bwd(
            q, k, v, bias, gate, out, lse, do), iters)
        plain_f = cuda_time(lambda: ref.evo_attention_ref(
            q, k, v, bias, gate, return_lse=True), 2)
        plain_b = cuda_time(lambda: ref.evo_attention_bwd_ref(
            q, k, v, bias, gate, out, lse, do), 2)
        # library: scaled_dot_product_attention with the same float bias
        # (no gate); backward = autograd's dq, dk, dv (no dbias, dgate or
        # sigmoid asked), its backend pinned so that every call and every
        # run times the same kernels
        qt, kt_, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                       for t in (q, k, v))
        mask = None if bias is None else bias.to(dt)
        lib_f = cuda_median(lambda: F.scaled_dot_product_attention(
            qt, kt_, vt, attn_mask=mask), iters)
        with sdpa_kernel(K2_LIBRARY_BACKEND):
            o_lib = F.scaled_dot_product_attention(qt, kt_, vt, attn_mask=mask)
            do_t = do.transpose(1, 2)
            lib_b = cuda_median(lambda: torch.autograd.grad(
                o_lib, (qt, kt_, vt), do_t, retain_graph=True), iters)
        del o_lib, qt, kt_, vt
        act = L * S * H * C * el
        f_flops = 4.0 * L * H * S * S * C
        f_bytes = 5 * act + (H * S * S * el if biased else 0) + L * H * S * 4
        b_flops = 10.0 * L * H * S * S * C
        b_bytes = (10 * act + (H * S * S * (el + 4) if biased else 0)
                   + L * H * S * 4)
        bf_ms, bf_by = bound(f_flops, f_bytes, peak)
        bb_ms, bb_by = bound(b_flops, b_bytes, peak)
        rows.append(dict(kernel="K1+lse", shape=name, dtype=str(dt)[6:], L=L,
                         S=S, H=H, C=C, biased=biased, per_cycle=2 * per,
                         max_abs_err=err_f, atol_needed=need_f,
                         **timed_fields("ms", ms_f),
                         plain_ms=plain_f, **timed_fields("library_ms", lib_f),
                         bound_ms=bf_ms, bound_by=bf_by))
        rows.append(dict(kernel="K2", shape=name, dtype=str(dt)[6:], L=L,
                         S=S, H=H, C=C, biased=biased, per_cycle=per,
                         max_abs_err=err_b, atol_needed=need_b,
                         **timed_fields("ms", ms_b),
                         plain_ms=plain_b, **timed_fields("library_ms", lib_b),
                         library_backend=K2_LIBRARY_BACKEND.name,
                         bound_ms=bb_ms, bound_by=bb_by,
                         gbps=b_bytes / ms_b[0] / 1e6))
        if dt == torch.bfloat16:
            _add(tots["k1_lse"], 2 * per, ms_f, plain_f, lib_f, bf_ms, f_flops,
                 f_bytes, err_f)
            _add(tots["k2"], per, ms_b, plain_b, lib_b, bb_ms, b_flops,
                 b_bytes, err_b)
        del q, k, v, gate, do, bias, out, lse, out_r, lse_r
        torch.cuda.empty_cache()
    return rows, tots


def check_triangle_train(dev, shapes, c_z, c, dtype, fp32_shape):
    """K3 with its fp32 s, K4, and K5 for both operand sides (the second
    with ds transposed by strides), per shape.  Returns (rows, totals per
    sample-cycle of bf16 training for K3-s, K4 and K5)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import triangle as kt
    g = torch.Generator(device=dev).manual_seed(8)
    rows, tots = [], {"k3_s": _tot(), "k4": _tot(), "k5": _tot()}
    runs = [(n, r, o, per, dtype) for n, r, o, per in shapes]
    runs.append(("fp32_" + fp32_shape[0], fp32_shape[1], fp32_shape[2], 0,
                 torch.float32))
    for name, r, outgoing, per, dt in runs:
        el = 2 if dt == torch.bfloat16 else 4
        peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_FP32_FLOPS
        x = _rand(g, (r, r, c_z), dt)
        w = (_rand(g, (c_z, 2 * c), dt, c_z ** -0.5), _rand(g, (2 * c,), dt, 0.5),
             _rand(g, (c_z, 2 * c), dt, c_z ** -0.5), _rand(g, (2 * c,), dt, 0.5),
             (1 + _rand(g, (c,), torch.float32, 0.1)).to(dt),
             _rand(g, (c,), dt, 0.1), _rand(g, (c, c_z), dt, c ** -0.5),
             _rand(g, (c_z,), dt, 0.1), _rand(g, (c_z, c_z), dt, c_z ** -0.5),
             _rand(g, (c_z,), dt, 0.5))
        w_a, b_a, w_b, b_b, ln_s, ln_b, w_o, b_o, w_g, b_g = w
        xab = x if outgoing else x.transpose(0, 1)
        dy = _rand(g, (r, r, c_z), dt)
        y, s_k = kt.triangle_mult_fwd(xab, xab, x, *w, return_s=True)
        y_r, s_r = ref.triangle_mult_ref(xab, xab, x, *w, return_s=True)
        torch.cuda.synchronize()
        extra = 0.0
        if dt == torch.bfloat16:
            # K3 stages the gated projections in bf16 and the plain version
            # rounds its own: an element may round one ulp apart, moving a
            # term of s by up to 2^-7 |a_k b_k|
            pa = ref.gated_projection(xab, w_a, b_a).to(dt).float().abs()
            pb = ref.gated_projection(xab, w_b, b_b).to(dt).float().abs()
            extra = 2.0 ** -7 * torch.einsum("ikc,jkc->ijc", pa, pb)
            del pa, pb
        err3 = max(check_close(y, y_r, f"K3 {name}"),
                   check_grad_close(s_k, s_r, f"K3 s {name}", extra))
        need3 = {"y": [atol_needed(y, y_r, RTOL), ATOL],
                 "s": grad_margin(s_k, s_r, extra)}
        del extra
        epi = kt.triangle_mult_bwd_epilogue(s_r, x, dy, ln_s, ln_b, w_o, b_o,
                                            w_g, b_g)
        epi_r = ref.triangle_mult_bwd_epilogue_ref(s_r, x, dy, ln_s, ln_b,
                                                   w_o, b_o, w_g, b_g)
        torch.cuda.synchronize()
        err4 = max(check_grad_close(a, b, f"K4 {name} {i}")
                   for i, (a, b) in enumerate(zip(epi, epi_r)))
        need4 = {out: grad_margin(a, b) for out, a, b in zip(
            ("ds", "dxg", "dln_s", "dln_b", "dw_o", "db_o", "dw_g", "db_g"),
            epi, epi_r)}
        ds = epi_r[0]
        sides = ((ds, w_a, b_a, w_b, b_b), (ds.transpose(0, 1), w_b, b_b, w_a, b_a))
        err5, need5 = 0.0, {}
        for side, (dsv, wl, bl, ws, bs) in enumerate(sides):
            got = kt.triangle_mult_bwd_dx(dsv, xab, xab, wl, bl, ws, bs)
            want = ref.triangle_mult_bwd_dx_ref(dsv, xab, xab, wl, bl, ws, bs)
            torch.cuda.synchronize()
            err5 = max([err5] + [check_grad_close(a, b, f"K5 {name} side {side} {i}")
                                 for i, (a, b) in enumerate(zip(got, want))])
            for out, a, b in zip(("dx", "dw", "db"), got, want):
                need5[f"side{side} {out}"] = grad_margin(a, b)
        del epi, epi_r, got, want
        ms3 = cuda_median(lambda: kt.triangle_mult_fwd(xab, xab, x, *w,
                                                       return_s=True), 10)
        ms4 = cuda_median(lambda: kt.triangle_mult_bwd_epilogue(
            s_k, x, dy, ln_s, ln_b, w_o, b_o, w_g, b_g), 10)
        # the second side, as the backward calls it: ds transposed by strides
        ms5 = cuda_median(lambda: kt.triangle_mult_bwd_dx(
            ds.transpose(0, 1), xab, xab, w_b, b_b, w_a, b_a), 10)
        plain3 = cuda_time(lambda: ref.triangle_mult_ref(xab, xab, x, *w,
                                                         return_s=True), 2)
        plain4 = cuda_time(lambda: ref.triangle_mult_bwd_epilogue_ref(
            s_k, x, dy, ln_s, ln_b, w_o, b_o, w_g, b_g), 2)
        plain5 = cuda_time(lambda: ref.triangle_mult_bwd_dx_ref(
            ds.transpose(0, 1), xab, xab, w_b, b_b, w_a, b_a), 2)
        # library: a bf16 einsum of the k-contraction, for K3 the forward's,
        # for K5 the backward's for the second operand side (ds read
        # transposed, the streamed side's projection); both cover only the
        # k-contraction (2 r^3 c operations).  None computes K4's LayerNorm
        # + out-projection + gate backward in one call
        a = ref.gated_projection(xab, w_a, b_a).to(dt)
        bb = ref.gated_projection(xab, w_b, b_b).to(dt)
        lib3 = cuda_median(lambda: torch.einsum("ikc,jkc->ijc", a, bb), 10)
        ds_lib = ds.transpose(0, 1).to(dt)
        lib5 = cuda_median(lambda: torch.einsum("pqc,qkc->pkc", ds_lib, a), 10)
        del ds_lib, a, bb
        # K4's products-only yardstick: the six products it contains, each
        # one bf16 torch.matmul (no split operands, no LayerNorm, gate or
        # sums), timed together; no single call computes K4
        P = r * r
        n_b, du_b, dz_b = (_rand(g, (P, n), dt) for n in (c, c_z, c_z))
        x2 = x.reshape(P, c_z)
        prods4 = cuda_median(lambda: (n_b @ w_o, x2 @ w_g, du_b @ w_o.t(),
                                      dz_b @ w_g.t(), n_b.t() @ du_b,
                                      x2.t() @ dz_b), 10)
        del n_b, du_b, dz_b, x2
        f3 = (2 * 2.0 * P * c_z * 2 * c + 2.0 * r ** 3 * c + 2.0 * P * c * c_z
              + 2.0 * P * c_z * c_z)
        by3 = 2 * P * c_z * el + sum(t.numel() * el for t in w) + P * c * 4
        f4 = 6 * 2.0 * P * c * c_z
        by4 = P * c * 4 * 2 + 3 * P * c_z * el + (c * c_z + c_z * c_z) * (el + 4)
        f5 = 2.0 * r ** 3 * c + 4 * 2.0 * P * c_z * 2 * c
        by5 = P * c * 4 + 3 * P * c_z * el + 2 * c_z * 2 * c * el + c_z * 2 * c * 4
        b3, b3_by = bound(f3, by3, peak)
        b4, b4_by = bound(f4, by4, peak)
        b5, b5_by = bound(f5, by5, peak)
        common = dict(shape=name, dtype=str(dt)[6:], r=r, c_z=c_z, c=c)
        rows += [dict(kernel="K3+s", per_cycle=2 * per, max_abs_err=err3,
                      atol_needed=need3, **timed_fields("ms", ms3), plain_ms=plain3,
                      **timed_fields("library_ms", lib3), bound_ms=b3,
                      bound_by=b3_by, **common),
                 dict(kernel="K4", per_cycle=per, max_abs_err=err4,
                      atol_needed=need4, **timed_fields("ms", ms4),
                      plain_ms=plain4, library_ms=None,
                      **timed_fields("products_ms", prods4),
                      bound_ms=b4, bound_by=b4_by, **common),
                 dict(kernel="K5", per_cycle=2 * per, max_abs_err=err5,
                      atol_needed=need5, **timed_fields("ms", ms5), plain_ms=plain5,
                      **timed_fields("library_ms", lib5), bound_ms=b5,
                      bound_by=b5_by, **common)]
        if dt == torch.bfloat16:
            _add(tots["k3_s"], 2 * per, ms3, plain3, lib3, b3, f3, by3, err3)
            _add(tots["k4"], per, ms4, plain4, None, b4, f4, by4, err4)
            add_timed(tots["k4"], "products_ms", per, prods4)
            _add(tots["k5"], 2 * per, ms5, plain5, lib5, b5, f5, by5, err5)
        del x, w, dy, y, s_k, y_r, s_r, ds
        torch.cuda.empty_cache()
    tots["k4"]["library_ms"] = None
    return rows, tots


# ---------------------------------------------------------------------------
# Phase 8: af2_tiny loss gradients, card against CPU
# ---------------------------------------------------------------------------

def small_train_check(dev):
    """af2_tiny training loss (n_recycle 2, no dropout) and every parameter
    gradient through the kernels on the card against the plain versions on
    the CPU.  The loss is ``loss_fn``'s, with one change: the pLDDT term's
    target bins (the binned lDDT-Cα of the predicted structure, a step
    function of the predicted distances) are those of the CPU's fp32 run on
    both sides, so a rounding-level move of a distance across an lDDT
    threshold cannot change the loss being compared.  fp32: the loss within
    1e-5 relative, each gradient leaf within 1e-4 * max(1, max|leaf|) +
    1e-3 |x| (the CPU's own tolerance against JAX).  bf16: the card's
    gradients may stray from the CPU's fp32 ones at most 3x as far
    (relative L2 over all leaves) as the CPU's own bf16 gradients do.
    Returns (fp32 max |diff|, bf16 card distance, bf16 CPU distance)."""
    import torch.nn.functional as Fn
    from repro_torch.core import heads as hd
    from repro_torch.core import model as af2
    from repro_torch.core.config import af2_tiny, with_kernels
    from repro_torch.data.protein import protein_batch
    cfg = with_kernels(af2_tiny())
    model = seeded_model(cfg, seed=4, noise=0.05)
    on_card = copy.deepcopy(model).to(dev)
    sample = {k: v[0] for k, v in protein_batch(4, 0, 1, cfg).items()}
    nb = cfg.n_plddt_bins

    def loss_of(m, dtype, bins=None):
        out = af2.forward(m, cfg, sample, n_recycle=2, dtype=dtype)
        b = af2.to_device(sample, out["z"].device)
        mask = b["res_mask"].float()
        if bins is None:
            lddt = hd.lddt_ca(out["trans"], b["true_trans"], mask,
                              per_residue=True).detach()
            bins = torch.clamp((lddt / 100.0 * nb).long(), 0, nb - 1).cpu()
        traj = out["traj"]
        loss = (0.5 * hd.fape_loss(traj[0], traj[1], b["true_rots"],
                                   b["true_trans"], mask)
                + 0.3 * hd.distogram_loss(hd.distogram_logits(m.heads, out["z"]),
                                          b["true_trans"], mask,
                                          n_bins=cfg.n_distogram_bins)
                + 2.0 * hd.masked_msa_loss(hd.masked_msa_logits(m.heads, out["msa"]),
                                           b["true_msa"],
                                           b["msa_mask_positions"].float())
                + 0.01 * hd.softmax_xent(hd.plddt_logits(m.heads, out["s_final"]),
                                         Fn.one_hot(bins.to(mask.device), nb).float(),
                                         mask))
        return loss, bins

    def grads(m, dtype, bins):
        m.zero_grad(set_to_none=True)
        loss, bins = loss_of(m, dtype, bins)
        loss.backward()
        return loss.item(), bins, {k: (p.grad if p.grad is not None
                                       else torch.zeros_like(p)).detach().float().cpu()
                                   for k, p in m.named_parameters()}

    loss32, bins, cpu32 = grads(model, torch.float32, None)
    with torch.no_grad():       # the unchanged loss agrees as well
        want = af2.loss_fn(model, cfg, sample, n_recycle=2, dtype=torch.float32)[0].item()
    if not abs(want - loss32) <= 1e-6 * abs(want):
        raise AssertionError(f"fixed-target loss {loss32} != loss_fn {want}")
    loss_c, _, card32 = grads(on_card, torch.float32, bins)
    if not abs(loss_c - loss32) <= 1e-5 * abs(loss32):
        raise AssertionError(f"af2_tiny fp32 loss: card {loss_c} CPU {loss32}")
    err32 = 0.0
    for k, w in cpu32.items():
        d = (card32[k] - w).abs()
        tol = 1e-4 * max(1.0, w.abs().max().item()) + 1e-3 * w.abs()
        if not bool((d <= tol).all()):
            raise AssertionError(f"af2_tiny fp32 grad {k}: max |diff| "
                                 f"{d.max().item()}")
        err32 = max(err32, d.max().item())
    norm = lambda gs: sum(x.square().sum() for x in gs.values()).sqrt().item()
    dist = lambda a: norm({k: a[k] - cpu32[k] for k in cpu32}) / norm(cpu32)
    _, _, cpu16 = grads(model, torch.bfloat16, bins)
    _, _, card16 = grads(on_card, torch.bfloat16, bins)
    d_card, d_cpu = dist(card16), dist(cpu16)
    if not d_card <= 3 * d_cpu:
        raise AssertionError(f"af2_tiny bf16 grads: card {d_card} from the "
                             f"fp32 grads, over 3x the CPU's bf16 {d_cpu}")
    return err32, d_card, d_cpu


# ---------------------------------------------------------------------------
# Phase 9: the training main path
# ---------------------------------------------------------------------------

def train_launches(cfg, n_recycle: int) -> dict:
    """Kernel launches one protein's training step implies: K1 and K3 run in
    every cycle's forward and once more in the grad cycle's remat recompute;
    K2 and K4 once per forward launch of the grad cycle, K5 twice (one per
    operand side)."""
    k1 = 4 * cfg.n_evoformer + 3 * cfg.n_extra_msa_blocks
    k3 = 2 * (cfg.n_evoformer + cfg.n_extra_msa_blocks)
    return {"evo_attention_fwd": k1 * (n_recycle + 1),
            "evo_attention_bwd": k1,
            "triangle_mult_fwd": k3 * (n_recycle + 1),
            "triangle_mult_bwd_epilogue": k3,
            "triangle_mult_bwd_dx": 2 * k3}


def train_main_path(cfg, dev, *, warmup=1, steps=3):
    """TrainRunner at ``cfg`` with its defaults, batch 1: ``warmup`` steps,
    then ``steps`` steps with the launch counters set to 0 just before and
    read just after, each step checked."""
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import TrainRunner
    model = seeded_model(cfg, seed=0).to(dev)
    runner = TrainRunner(cfg, batch_size=1, seed=0, device=dev, model=model)
    runner.run(warmup)
    before = {k: p.detach().clone() for k, p in runner.model.named_parameters()}
    ema_before = {k: e.clone() for k, e in runner.state["ema"].items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    norms = []
    for _ in range(steps):
        runner.run(runner.step + 1)
        m = runner.last_metrics
        if not all(np.isfinite(m[k]) for k in ("loss", "grad_norm",
                                                "sample_grad_norm")):
            raise AssertionError(f"step {runner.step - 1}: {m}")
        norms.append(m["sample_grad_norm"])
    counts = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    drawn = runner.history["n_recycle"][warmup:]
    want = {k: 0 for k in counts}
    for nr in drawn:
        for k, v in train_launches(runner.cfg, nr).items():
            want[k] += v
    if counts != want:
        raise AssertionError(f"training launches {counts} != the path's {want} "
                             f"(n_recycle {drawn})")
    moved = sum(not torch.equal(p, before[k])
                for k, p in runner.model.named_parameters())
    ema_moved = sum(not torch.equal(e, ema_before[k])
                    for k, e in runner.state["ema"].items())
    if moved < 0.9 * len(before) or ema_moved < 0.9 * len(before):
        raise AssertionError(f"{moved} parameters / {ema_moved} EMA leaves "
                             f"of {len(before)} changed")
    return runner, counts, norms, peak_gib


# ---------------------------------------------------------------------------
# Phases 10 and 11: the LM serving path, K6 and glm4-9b
# ---------------------------------------------------------------------------

LM_ARCH = "glm4-9b"
LM_PROMPTS = (512, 1000, 2048, 3000, 512, 1000, 2048, 3000)
LM_NEW_TOKENS = 32
LM_SLOTS, LM_MAX_LEN = 4, 4096


def causal_pairs(s: int, t: int) -> int:
    """(query, key) pairs a causal mask keeps: query i sees keys 0..i."""
    k = min(s, t)
    return k * (k + 1) // 2 + (s - k) * t


def lm_kernel_shapes(cfg):
    """K6 rows: (name, (B, S, T, H, KV, D), causal, dtype, launches on the
    main path): one per prompt length of the path (one launch per layer per
    prompt), then checks the path does not reach."""
    H, KV, D = cfg.n_head, cfg.n_kv_head, cfg.d_head
    bf, f32 = torch.bfloat16, torch.float32
    per_len = collections.Counter(LM_PROMPTS)
    rows = [(f"prefill_S{n}", (1, n, n, H, KV, D), True, bf,
             cfg.n_layer * per_len[n]) for n in sorted(per_len)]
    rows += [("noncausal_S64_T128", (1, 64, 128, H, KV, D), False, bf, 0),
             ("causal_S130_T70", (1, 130, 70, H, KV, D), True, bf, 0),
             ("fp32_ragged_S300", (1, 300, 300, H, KV, D), True, f32, 0),
             ("d64_ragged_S100", (2, 100, 100, 8, 2, 64), True, bf, 0),
             ("d32_ragged_S77_noncausal", (2, 77, 77, 4, 2, 32), False, bf, 0),
             ("d64_fp32_S128", (1, 128, 128, 4, 2, 64), True, f32, 0),
             ("d32_fp32_S77", (2, 77, 77, 4, 2, 32), False, f32, 0)]
    return rows


def check_flash_attention(dev, shapes):
    """K6 against its plain version per shape: max |diff| (bf16: K6_ATOL +
    RTOL |plain|; fp32: 2e-4 + 1e-5 |plain|, the reference's fp32 kernel
    tolerance), times, bound.  Returns (rows, totals over the main path's
    launches)."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(13)
    rows, tot = [], _tot()
    for name, (B, S, T, H, KV, D), causal, dt, launches in shapes:
        el = 2 if dt == torch.bfloat16 else 4
        peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_FP32_FLOPS
        q = _rand(g, (B, S, H, D), dt)
        k, v = (_rand(g, (B, T, KV, D), dt) for _ in range(2))
        got = kf.flash_attention_fwd(q, k, v, causal)
        want = ref.flash_attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        atol, rtol = (K6_ATOL, RTOL) if dt == torch.bfloat16 else (2e-4, 1e-5)
        err = check_close(got, want, f"K6 {name}", atol=atol, rtol=rtol)
        needed = atol_needed(got, want, rtol)
        del got, want
        iters = 20 if B * H * S * T < 2 ** 26 else 5
        ms = cuda_median(lambda: kf.flash_attention_fwd(q, k, v, causal), iters)
        plain_ms = cuda_time(lambda: ref.flash_attention_ref(q, k, v, causal), 2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))    # (B, heads, S, D)
        lib_ms = cuda_median(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), iters)
        pairs = causal_pairs(S, T) if causal else S * T
        flops = 4.0 * B * H * D * pairs
        nbytes = (2 * B * S * H * D + 2 * B * T * KV * D) * el
        b_ms, b_by = bound(flops, nbytes, peak)
        rows.append(dict(shape=name, dtype=str(dt)[6:], B=B, S=S, T=T, H=H,
                         KV=KV, D=D, causal=causal, launches=launches,
                         max_abs_err=err, atol=atol, atol_needed=needed,
                         **timed_fields("ms", ms),
                         plain_ms=plain_ms, **timed_fields("library_ms", lib_ms),
                         bound_ms=b_ms, bound_by=b_by,
                         tflops=flops / ms[0] / 1e9))
        _add(tot, launches, ms, plain_ms, lib_ms, b_ms, flops, nbytes,
             err if launches else 0.0)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows, tot


# requests whose every logit row is held against the plain path: rid 3
# (prompt 3000, slot 3, beside three live slots) and rid 5 (prompt 1000,
# slot 1 after rid 1 left it, beside three live slots)
LM_CHECKED = (3, 5)
# the served logits may lie at most this many times as far from the fp32
# value as the plain bf16 path's: both are bf16 runs of the same function,
# and their distances agree within 7% on the card; at 3x a decode that
# leaves out each token's own key passed (1.97x)
LM_NOISE_FACTOR = 1.5


class LogitRecorder:
    """Wraps a DecodeEngine's steps ``_prefill1`` and ``_decode`` (eager
    functions, or CUDA-graph replays), so it sees every call, and keeps the
    logits they return to the engine for the requests ``rids``: each
    prefill's last row (in insert order, matched to a request through the
    engine's ``last_stats``) and their slot's row at each decode step
    (cloned: a graph's static output is overwritten by the next replay)."""

    def __init__(self, engine, rids):
        self.engine, self.rids = engine, set(rids)
        self.clear()
        self._steps = engine._prefill1, engine._decode
        engine._prefill1, engine._decode = self._prefill, self._decode

    def restore(self):
        """Give the engine back its own steps."""
        self.engine._prefill1, self.engine._decode = self._steps

    def clear(self):
        self.prefills, self.steps = [], collections.defaultdict(list)

    def _prefill(self, prompt):
        logits = self._steps[0](prompt)
        self.prefills.append(logits[0, -1].clone())
        return logits

    def _decode(self, tokens):
        logits = self._steps[1](tokens)
        for i, req in enumerate(self.engine.slots):
            if req is not None and req.rid in self.rids:
                self.steps[req.rid].append(logits[i, 0].clone())
        return logits

    def logits(self, rid):
        """(new tokens, V): the rows the engine took each token of ``rid``
        from."""
        order = [p["rid"] for p in self.engine.last_stats["prefill"]]
        return torch.stack([self.prefills[order.index(rid)],
                            *self.steps[rid]])


def lm_params(dev):
    """glm4-9b's config and seeded bf16 weights drawn on the card; returns
    (cfg, params, seconds to draw them)."""
    from repro_torch import configs
    from repro_torch.models import dense
    from repro_torch.models.lmconfig import with_kernels
    cfg = with_kernels(configs.get_config(LM_ARCH))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = dense.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


def lm_main_path(cfg, params, dev, *, graphs: bool):
    """glm4-9b through a DecodeEngine (``graphs`` on or off) that serves
    through a LogitRecorder: warm-up requests (one of 64 tokens; with
    graphs also one of each main-path prompt length, so that every step is
    captured before the measured run), then the 8 requests with the launch
    counters set to 0 just before and read just after.  Returns (engine,
    recorder, requests, results, launch counts, wall seconds, peak
    allocated GiB, reserved GiB, warm-up seconds)."""
    from repro_torch.kernels import ops
    from repro_torch.models import dense
    from repro_torch.serve.engine import DecodeEngine, Request
    engine = DecodeEngine(dense, cfg, params, batch_slots=LM_SLOTS,
                          max_len=LM_MAX_LEN, device=dev, graphs=graphs)
    rec = LogitRecorder(engine, LM_CHECKED)
    rng = np.random.default_rng(0)
    prompt = lambda n: rng.integers(0, cfg.vocab, n, dtype=np.int32)
    warm = [Request(rid=-1, prompt=prompt(64), max_new_tokens=2)]
    reqs = [Request(rid=i, prompt=prompt(n), max_new_tokens=LM_NEW_TOKENS)
            for i, n in enumerate(LM_PROMPTS)]
    if graphs:
        warm += [Request(rid=-2 - i, prompt=prompt(n), max_new_tokens=2)
                 for i, n in enumerate(sorted(set(LM_PROMPTS)))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(warm)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rec.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved_gib = torch.cuda.memory_reserved() / 2 ** 30
    return (engine, rec, reqs, done, counts, wall, peak_gib, reserved_gib,
            warm_s)


def plain_lm_logits(params, cfg, tokens, start: int, dtype):
    """Logits (S - start, V), fp32, at positions start.. of ``tokens``
    (1, S) on the plain path: ``forward``'s body with chunked attention and
    no cache, activations in ``dtype`` (bf16 as ``forward``; fp32 gives the
    value of the same bf16 weights)."""
    from repro_torch.models import dense
    cfg = dataclasses.replace(cfg, attention_impl="chunked")
    with torch.no_grad():
        x = params.embed.table[tokens.long()].to(dtype)
        pos = torch.arange(tokens.shape[1], dtype=torch.int32,
                           device=tokens.device)[None]
        x = dense.backbone(params, cfg, x, pos)
        return dense.logits_fn(params, cfg, x[:, start:])[0].float()


def check_lm_main_path(cfg, engine, rec, reqs, done, counts, refs) -> list:
    """Every request's 32 token ids in the vocabulary; K6 launched once per
    layer per prompt and nothing else.  For each request of LM_CHECKED, the
    engine's logits for all its tokens (the prefill's last row, then its
    slot's row of each batched decode step, read from the slot-copied cache)
    against the plain path on prompt + tokens[:-1]: no farther from the fp32
    value than LM_NOISE_FACTOR times the plain bf16 path, and each token the
    argmax of its row.  ``refs`` keeps the plain path's values by request
    and tokens, for a second run that served the same tokens.  Returns per
    checked request (rid, max |served - fp32|, max |plain bf16 - fp32|)."""
    if sorted(done) != [r.rid for r in reqs]:
        raise AssertionError(f"served {sorted(done)}")
    for r in reqs:
        toks = np.asarray(done[r.rid])
        if toks.shape != (LM_NEW_TOKENS,) or toks.min() < 0 or \
                toks.max() >= cfg.vocab:
            raise AssertionError(f"request {r.rid}: tokens {toks}")
    want = {k: 0 for k in counts}
    want["flash_attention_fwd"] = cfg.n_layer * len(reqs)
    if counts != want:
        raise AssertionError(f"LM launches {counts} != the path's {want}")
    out = []
    for rid in LM_CHECKED:
        prompt, gen = reqs[rid].prompt, done[rid]
        served = rec.logits(rid).float()
        if served.shape != (LM_NEW_TOKENS, cfg.vocab) or not torch.equal(
                served.argmax(-1).cpu(), torch.as_tensor(gen)):
            raise AssertionError(f"request {rid}: recorded logits "
                                 f"{tuple(served.shape)} do not give its "
                                 f"tokens")
        key = (rid, tuple(gen))
        if key not in refs:
            tokens = torch.as_tensor(np.concatenate([prompt, gen[:-1]]),
                                     device=engine.device)[None]
            start = len(prompt) - 1
            ref32 = plain_lm_logits(engine.params, cfg, tokens, start,
                                    torch.float32)
            noise = (plain_lm_logits(engine.params, cfg, tokens, start,
                                     torch.bfloat16) - ref32).abs().max().item()
            refs[key] = ref32, noise
        ref32, noise = refs[key]
        err = (served - ref32).abs().max().item()
        print(f"[lm check] request {rid} (prompt {len(prompt)}): max |served "
              f"- fp32| {err:.4g}, plain bf16 {noise:.4g}, |fp32| max "
              f"{ref32.abs().max().item():.4g}", flush=True)
        if not err <= LM_NOISE_FACTOR * noise:
            raise AssertionError(f"request {rid}: served logits {err} from "
                                 f"the fp32 plain path, over "
                                 f"{LM_NOISE_FACTOR} x {noise}")
        out.append((rid, err, noise))
    return out


def lm_report(tag, cfg, engine, done, wall, peak_gib, reserved_gib, warm_s,
              init_s, n_params, errs):
    st = engine.last_stats
    pre = st["prefill"]
    pre_tok = sum(p["prompt_len"] for p in pre)
    pre_s = sum(p["seconds"] for p in pre)
    dec_tok, dec_s = sum(st["decode_tokens"]), sum(st["decode_step_s"])
    steps = sorted(st["decode_step_s"])
    by_len = collections.defaultdict(list)
    for p in pre:
        by_len[p["prompt_len"]].append(p)
    ttft = {n: dict(prefill_s=[round(p["seconds"], 4) for p in ps],
                    first_token_s=[round(p["first_token_s"], 4) for p in ps])
            for n, ps in sorted(by_len.items())}
    total = sum(len(v) for v in done.values())
    print(f"[lm path {tag}] {LM_ARCH} ({cfg.n_layer} layers, d "
          f"{cfg.d_model}, {n_params / 1e9:.2f} B parameters, bf16 weights "
          f"drawn in {init_s:.1f}s) DecodeEngine {LM_SLOTS} slots, cache "
          f"{LM_MAX_LEN}, warm-up {warm_s:.2f}s, compile_misses "
          f"{engine.compile_misses}: "
          f"{len(done)} requests, {total} tokens in {wall:.2f}s = "
          f"{total / wall:.1f} tokens/s; prefill {pre_tok} tokens in "
          f"{pre_s:.3f}s = {pre_tok / pre_s:.0f} tokens/s; decode {dec_tok} "
          f"tokens in {len(steps)} steps, {dec_s:.3f}s = "
          f"{dec_tok / dec_s:.1f} tokens/s; decode step median "
          f"{1e3 * steps[len(steps) // 2]:.2f} ms (min {1e3 * steps[0]:.2f}, "
          f"max {1e3 * steps[-1]:.2f}); peak memory {peak_gib:.2f} GiB "
          f"allocated, {reserved_gib:.2f} GiB reserved; "
          f"served logits vs the fp32 plain path (rid, max |diff|, plain "
          f"bf16's) {[(r, round(e, 4), round(n, 4)) for r, e, n in errs]}",
          flush=True)
    print(f"[lm path {tag}] time to first token by prompt length (prefill "
          f"alone; "
          f"from the run's start, queueing included): {json.dumps(ttft)}",
          flush=True)


def profile_lm(cfg, engine):
    """One prefill at S 2048 (batch 1) and one decode step of the engine's
    4 slots, each plain and under torch.profiler: eagerly through
    ``models/dense.py``, then as the graphed engine's captured steps."""
    from repro_torch.models import dense
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, 2048, dtype=np.int64),
                             device=engine.device)[None]
    cache = dense.init_cache(cfg, 1, LM_MAX_LEN, device=engine.device)
    what = f"{LM_ARCH} prefill S 2048, batch 1"
    profile_run(lambda: dense.prefill(engine.params, cfg, prompt, cache),
                "lm_prefill", what)
    profile_run(lambda: engine._prefill1(prompt), "lm_prefill_graphed",
                what + ", graph replay")
    tokens = torch.zeros((LM_SLOTS, 1), dtype=torch.int32, device=engine.device)
    what = f"{LM_ARCH} decode step, {LM_SLOTS} slots, cache {LM_MAX_LEN}"
    profile_run(lambda: dense.decode_step(engine.params, cfg, tokens,
                                          engine.cache), "lm_decode", what)
    profile_run(lambda: engine._decode(tokens), "lm_decode_graphed",
                what + ", graph replay")


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit("chip_smoke.py: src/repro_torch not found — run it "
                         "from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core.config import af2_initial
    from repro_torch.kernels import build

    card = device_line()
    dev = torch.device("cuda")
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}", flush=True)

    build_s = build.build_all()
    print(f"[build] {len(build.SOURCES)} sources in {build_s:.1f}s", flush=True)
    for name in build.SOURCES:
        for line in build.ptxas_report(name).splitlines():
            print(f"[build] {name}: {line.strip()}")

    cfg = af2_initial()
    k1_shapes, k3_shapes = path_shapes(cfg)
    k1_rows, k1_tot, k1_err = check_evo_attention(dev, k1_shapes)
    for row in k1_rows:
        print(f"[kernel] evo_attention_fwd {json.dumps(row)}", flush=True)
    k3_rows, k3_tot, k3_err = check_triangle(
        dev, k3_shapes, cfg.evoformer.c_z, cfg.evoformer.c_hidden_mul)
    for row in k3_rows:
        print(f"[kernel] triangle_mult_fwd {json.dumps(row)}", flush=True)

    err32, err16, noise16 = small_fold_check(dev)
    print(f"[small fold] af2_tiny coords max |diff|: fp32 card vs CPU "
          f"{err32:.3g}; bf16 card vs fp32 CPU {err16:.3g} (CPU bf16 "
          f"{noise16:.3g}, bound 3x)", flush=True)

    # phases 5 and 6, eager: the same engine without graphs
    reqs, engine = main_path(cfg, dev, graphs=False)
    eager = serve_folds(engine, reqs)
    sample_cycles = check_main_path(cfg, reqs, eager[0], engine, eager[1])
    fold_report("eager", cfg, eager[0], engine, *eager[1:], sample_cycles)
    profile_step(engine, reqs, eager[0], "fold")
    del engine
    torch.cuda.empty_cache()
    # phases 5 and 6, graphed: the first run captures each bucket's
    # sample-cycle, the second replays only
    reqs, engine = main_path(cfg, dev, graphs=True)
    for tag in ("graphed, with captures", "graphed"):
        graphed = serve_folds(engine, reqs)
        check_main_path(cfg, reqs, graphed[0], engine, graphed[1])
        if engine.compile_misses != len({r.bucket for r in graphed[0].values()}):
            raise AssertionError(f"compile_misses {engine.compile_misses}")
        fold_report(tag, cfg, graphed[0], engine, *graphed[1:], sample_cycles)
    d_xyz = max(np.abs(graphed[0][i].coords - eager[0][i].coords).max()
                for i in eager[0])
    d_plddt = max(np.abs(graphed[0][i].plddt - eager[0][i].plddt).max()
                  for i in eager[0])
    print(f"[main path] graphed vs eager: max |coords diff| {d_xyz:.6g}, "
          f"max |pLDDT diff| {d_plddt:.6g}; wall {eager[2]:.3f} -> "
          f"{graphed[2]:.3f} s", flush=True)
    profile_step(engine, reqs, graphed[0], "fold_graphed")
    counts = graphed[1]
    del engine, eager, graphed
    torch.cuda.empty_cache()

    att_shapes, tri_shapes = train_shapes(cfg)
    att_rows, att_tot = check_attention_train(
        dev, att_shapes, torch.bfloat16, ("msa_row", (16, 256, 8, 32)))
    tri_rows, tri_tot = check_triangle_train(
        dev, tri_shapes, cfg.evoformer.c_z, cfg.evoformer.c_hidden_mul,
        torch.bfloat16, ("incoming", 128, False))
    for row in att_rows + tri_rows:
        print(f"[train kernel] {json.dumps(row)}", flush=True)
    for name, tot in {**att_tot, **tri_tot}.items():
        print(f"[train kernel total] {name} per sample-cycle: "
              f"{json.dumps(tot)}", flush=True)

    t_err32, t_d16, t_n16 = small_train_check(dev)
    print(f"[small train] af2_tiny loss gradients: fp32 card vs CPU max "
          f"|diff| {t_err32:.3g}; bf16 card {t_d16:.3g} from the CPU's fp32 "
          f"gradients (CPU bf16 {t_n16:.3g}, bound 3x)", flush=True)

    runner, t_counts, norms, t_peak = train_main_path(cfg, dev)
    step_s = runner.history["step_s"][1:]
    drawn = runner.history["n_recycle"][1:]
    print(f"[train path] af2_initial (48+4 blocks) TrainRunner, batch 1: "
          f"steps {list(range(1, runner.step))}, n_recycle {drawn}, losses "
          f"{[round(x, 4) for x in runner.history['loss'][1:]]}, gradient "
          f"norms before the 0.1 clip "
          f"{[round(x, 4) for x in norms]}; step latency "
          f"{[round(x, 3) for x in step_s]} s = "
          f"{len(step_s) / sum(step_s):.3f} proteins/s; peak memory "
          f"{t_peak:.2f} GiB; launches {t_counts}", flush=True)
    nr_prof = runner.recycle_draw(runner.step)
    profile_run(lambda: runner.run(runner.step + 1), "train",
                f"training step {runner.step}, n_recycle {nr_prof}")
    del runner
    torch.cuda.empty_cache()

    from repro_torch import configs
    k6_rows, k6_tot = check_flash_attention(
        dev, lm_kernel_shapes(configs.get_config(LM_ARCH)))
    for row in k6_rows:
        print(f"[lm kernel] flash_attention_fwd {json.dumps(row)}", flush=True)
    print(f"[lm kernel total] K6 over the main path's prefills: "
          f"{json.dumps(k6_tot)}", flush=True)

    lm_cfg, lm_weights, lm_init_s = lm_params(dev)
    n_params = sum(p.numel() for p in lm_weights.parameters())
    refs, served = {}, {}
    for tag, use in (("eager", False), ("graphed", True)):
        lm_engine, lm_rec, lm_reqs, lm_done, lm_counts, lm_wall, lm_peak, \
            lm_reserved, lm_warm_s = lm_main_path(lm_cfg, lm_weights, dev,
                                                  graphs=use)
        lm_errs = check_lm_main_path(lm_cfg, lm_engine, lm_rec, lm_reqs,
                                     lm_done, lm_counts, refs)
        if lm_engine.compile_misses != 1 + len(set(LM_PROMPTS) | {64}):
            raise AssertionError(f"compile_misses {lm_engine.compile_misses}")
        lm_report(tag, lm_cfg, lm_engine, lm_done, lm_wall, lm_peak,
                  lm_reserved, lm_warm_s, lm_init_s, n_params, lm_errs)
        print(f"[lm path {tag}] launches {lm_counts}", flush=True)
        served[tag] = lm_done, {rid: lm_rec.logits(rid) for rid in LM_CHECKED}
        lm_rec.restore()
        if not use:
            del lm_engine, lm_rec
            torch.cuda.empty_cache()
    (e_done, e_logits), (g_done, g_logits) = served["eager"], served["graphed"]
    differ = sum(a != b for r in e_done for a, b in zip(e_done[r], g_done[r]))
    d_logits = max((g_logits[r].float() - e_logits[r].float()).abs().max().item()
                   for r in LM_CHECKED)
    print(f"[lm path] graphed vs eager: every token id agrees: {differ == 0} "
          f"({differ} of {sum(len(v) for v in e_done.values())} differ); max "
          f"|logits diff| of requests {list(LM_CHECKED)} {d_logits:.6g}",
          flush=True)
    profile_lm(lm_cfg, lm_engine)

    def entry(name, source, replaces, tot, err, launches, per):
        by = tot["flops"] / PEAK_BF16_FLOPS >= tot["bytes"] / PEAK_BYTES
        lib = tot["library_ms"]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                "bound_ms": tot["bound_ms"],
                "bound_by": "operations" if by else "bytes",
                "library_ms": lib, "per": per}
    serve_per = "one sample-cycle of af2_initial serving, bucket r 256"
    train_per = "the backward of one af2_initial training sample-cycle"
    kernels = [
        entry("evo_attention_fwd", "src/repro_torch/csrc/evo_attention_fwd.cu",
              "src/repro/kernels/flash_attention.py:181", k1_tot, k1_err,
              counts["evo_attention_fwd"], serve_per),
        entry("triangle_mult_fwd", "src/repro_torch/csrc/triangle_mult_fwd.cu",
              "src/repro/kernels/triangle.py:128", k3_tot, k3_err,
              counts["triangle_mult_fwd"], serve_per),
        entry("evo_attention_bwd", "src/repro_torch/csrc/evo_attention_bwd.cu",
              "src/repro/kernels/flash_attention.py:347", att_tot["k2"],
              att_tot["k2"]["err"], t_counts["evo_attention_bwd"], train_per),
        {**entry("triangle_mult_bwd_epilogue",
                 "src/repro_torch/csrc/triangle_mult_bwd.cu",
                 "src/repro/kernels/triangle.py:239", tri_tot["k4"],
                 tri_tot["k4"]["err"], t_counts["triangle_mult_bwd_epilogue"],
                 train_per),
         "products_ms": tri_tot["k4"]["products_ms"]},
        entry("triangle_mult_bwd_dx",
              "src/repro_torch/csrc/triangle_mult_bwd.cu",
              "src/repro/kernels/triangle.py:319", tri_tot["k5"],
              tri_tot["k5"]["err"], t_counts["triangle_mult_bwd_dx"],
              train_per),
        entry("flash_attention_fwd",
              "src/repro_torch/csrc/flash_attention_fwd.cu",
              "src/repro/kernels/flash_attention.py:77", k6_tot,
              k6_tot["err"], lm_counts["flash_attention_fwd"],
              f"the prefills of the {LM_ARCH} main path (8 prompts x "
              f"{lm_cfg.n_layer} layers)"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
