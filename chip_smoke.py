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
     |diff| of coordinates and pLDDT.  The graphed engine keeps a
     MetricRegistry and a SpanTracer: after phase 6 and again after phase
     5b its serve/* counters must equal its stats, each bucket's
     serve/bucket_steps counter and serve/bucket_step_s count its steps,
     one serve/call event stand for each run / serve call, the fold_step
     and recycle_step spans number run's and serve's steps, and the
     serve/report/* gauges equal its last report.
  6. profile: one more largest-bucket step of each engine, eager and
     graphed, plain and under torch.profiler (device busy time, idle share,
     host launch calls, time by kernel family; K1 and K3 must show in
     both).
  5b. continuous serving: FoldEngine.serve on phase 5's graphed engine (its
     recycle steps replay the sample-cycle graphs phase 5 captured), 10
     requests (8 of seed 1, Poisson arrivals at 4 a virtual second,
     deadlines at arrival + 3 s, every third at priority 1, and two repeats
     of requests 0 and 1 ten virtual seconds after the others), 2
     featurize threads, starvation bound 4, a result cache of 64, measured
     step costs; served continuously, then FIFO.  Every request served,
     the repeats from the cache; continuous, FIFO and engine.run agree bit
     for bit; K1 and K3 launches equal the per-sample-cycle counts times
     the sample-cycles run (none for a cache hit, no backward kernel); a
     request's fold, recycles and finish time do not move when a second is
     admitted into its lane mid-flight (injected costs); compile_misses <=
     2 x the bucket table.  Prints latency percentiles, goodput, on-time
     fraction, utilization, stage ms, steps, forced admissions, hit rate,
     median step wall by bucket, host <-> device bytes a step beside the
     reference's host-carry bytes, memory: smoke readings, which at 10
     requests and light load compare no policies.  Then long_plan routing at
     16 + 4 blocks, eager, 2 recycles, injected costs: a one-device engine
     here, then two gloo rank processes on the card (plan data=2, long_plan
     dap=2 from r 256); the r-256 request's K1 launches at half the lead
     rows, every fold within 2e-3 relative L2 of the one device's, an
     indivisible bucket raising PlanError before any collective, and
     graphs=True raising under gloo; then plan None (the short buckets on
     one device per rank) with measured step costs, which the ranks agree
     every step, so both ranks' schedules must be equal.
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
     clipping, EMA, stochastic recycling 1..4, dropout, remat="block", the
     synthetic stream through the DataPipeline with its device stage),
     from the seeded model, three times over the same steps: eagerly
     (graphs=False), eagerly again (the yardstick of how far two eager runs
     agree) and graphed (one CUDA graph per drawn n_recycle).  Four warm-up
     steps (graphed: they capture every draw of 1..4, each capture's cost
     printed), then 3 measured steps, each with finite losses and gradient
     norms, changed parameters and EMA, and launch counters equal to what
     each step's drawn n_recycle implies (graphed: through replay credits);
     the max |diff| of losses, parameters and EMA, graphed vs eager beside
     eager vs eager; step walls by draw, allocated and reserved memory;
     graphed training may stray from eager no farther than the second
     eager run does; one more step of each runner under torch.profiler;
     then lDDT-Cα of the EMA parameters on the held-out split through the
     eager runner's FoldEngine and twice through the graphed one's
     (eval_compiles must stay 1, the two graphed evaluations agree), with
     train_compiles, eval_compiles and compile_misses.  Every step wall is
     its runner's ``step`` span (here and in 9b, 9c).  Telemetry: the
     graphed runner, built with a registry (MemorySink and a JSONL file)
     and a SpanTracer, trains steps 9-14 with an evaluation, a checkpoint
     and torch.profiler over step 12; its history must be the registry's
     six series, the
     sink's loss rows its losses, one step span per step with its draw,
     featurize spans on worker threads, device_put / input_wait / eval /
     checkpoint spans in order, ckpt/* series and data/* gauges, JSONL rows
     in seq order, each of K1-K5 in the profiled step's trace as often as
     its draw launches it, and an attribution row with 0 < MFU <= 1;
     prints the attribution (model FLOPs, predicted and measured step,
     MFU, goodput); then steps 15-29, one run call each, with the file
     sinks and tracer at every other step of a draw and without them at
     the rest, and prints each draw's step walls with and without.
  9b. training data and checkpoints, af2_initial at full width and depth,
     batch 1: (a) the record-path DataPipeline (8 demo FASTA records,
     length-bucketed, 2 workers) places 6 batches on the card, which must
     equal the same pipeline's batches on the CPU bit for bit; (b) graphed
     TrainRunners on those records, one cycle a step, checkpoints every 3
     steps (2 kept): run A trains 6 steps, run B (a runner from another
     model seed) restores step 3 and trains to 6, run C (run A's runner)
     restores step 3 into its captured graph and replays steps 3-5; B and C
     must equal A within phase 9's eager-vs-eager distance, restoring
     captures nothing, launch counts equal each run's steps; (c) two graphed
     steps at remat="dots" against remat="block", the same bound, with
     peak memory and step walls; featurize, stall, transfer, fill, bucket
     counts, checkpoint bytes and snapshot / save / restore seconds.
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
     max |diff| of the checked logits, and the model-FLOP share of the
     bf16 peak of each prefill length and decode step (model_flops); then
     one prefill (S 2048) and one decode step under torch.profiler, eager
     and as graph replays.
 12. static analysis (``repro_torch.analysis``): (a) ``python -m
     repro_torch.analysis.lint`` on the card (four gloo ranks sharing it)
     must exit 0 with "lint: OK", 8 programs, 40 pass runs, 0 skipped and
     0 unwaived; prints each program's peak_op_elems, findings and async
     overlap (overlapped pairs of pairs).  (b) fold:serial captured on the
     card and on the CPU: the same peak_op_elems (61440, the reference's)
     and finding codes, the same kernel nodes, and K1 / K3 launched during
     the card's capture (the launch counters are restored afterwards).
     (c) ``python -m repro_torch.launch.train --af2 initial --steps 2
     --batch 1 --lint --hlo-check``: lint/ok 1 in its metric stream, two
     steps trained, and its one train/async_overlap_ok row skipped for
     the one reason that one device gives (no async pair; 0 pairs), so a
     trace that raised, recorded as skipped with the exception as its
     reason, fails.  The phase's wall is printed beside the card's name
     and power limit.
Kernel and library times are medians of 5 timed repeats, each after a
warm-up call, printed with their min-max spread.  Then one JSON line of
kernel figures, the nvidia-smi line, and the result line ``{"ok": true,
"device": {...}}`` last.
"""
import collections
import contextlib
import copy
import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
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
              max_recycle=3, obs=None, tracer=None):
    """A FoldEngine (``graphs`` on or off; registry ``obs``, ``tracer``)
    over the seeded model and the main path's ``n_requests`` requests;
    returns (requests, engine)."""
    from repro_torch.data.synthetic import make_fold_requests
    from repro_torch.serve.fold_engine import FoldEngine
    model = seeded_model(cfg, seed=0)
    engine = FoldEngine(cfg, model, micro_batch=micro_batch,
                        max_recycle=max_recycle, tol=0.0, device=dev,
                        graphs=graphs, obs=obs, tracer=tracer)
    return make_fold_requests(cfg, n_requests, seed=0), engine


def count_calls(engine) -> collections.Counter:
    """Count ``engine.run`` and ``engine.serve`` calls from now on, by
    kind (the instance's methods wrapped)."""
    calls = collections.Counter()
    for kind in ("run", "serve"):
        def counted(*a, _fn=getattr(engine, kind), _kind=kind, **kw):
            calls[_kind] += 1
            return _fn(*a, **kw)
        setattr(engine, kind, counted)
    return calls


def check_serve_obs(engine, calls, tag: str) -> None:
    """The engine's telemetry against its own books: every ``serve/*``
    counter equals ``stats``; per bucket the ``serve/bucket_steps`` counter
    and the ``serve/bucket_step_s`` histogram's count equal its steps; one
    ``serve/call`` event per call; as many ``fold_step`` spans as ``run``'s
    steps and ``recycle_step`` spans as ``serve``'s; the ``serve/report/*``
    gauges equal ``last_report``."""
    obs, tr = engine.obs, engine.tracer
    bad = [k for k in engine._SCALAR_STATS
           if obs.counter(f"serve/{k}").value != engine.stats[k]]
    for b, pb in engine.stats["per_bucket"].items():
        t = b.describe()
        if not (obs.counter("serve/bucket_steps", bucket=t).value
                == obs.histogram("serve/bucket_step_s", bucket=t).count
                == pb["steps"]
                and obs.counter("serve/bucket_requests", bucket=t).value
                == pb["requests"]):
            bad.append(t)
    events = obs.series("serve/call")
    kinds = collections.Counter(e["call"] for e in events)
    steps = {k: sum(e["steps"] for e in events if e["call"] == k)
             for k in ("run", "serve")}
    spans = {"run": len(tr.spans("fold_step")),
             "serve": len(tr.spans("recycle_step"))}
    if kinds != calls or spans != steps:
        bad.append(f"calls {dict(calls)} events {dict(kinds)}, steps "
                   f"{steps} spans {spans}")
    gauges = {k: obs.gauge(f"serve/report/{k}").value
              for k in ("p50_ms", "p99_ms", "goodput_rps")}
    if calls["serve"] and gauges != {k: float(engine.last_report[k])
                                     for k in gauges}:
        bad.append(f"report gauges {gauges}")
    if bad:
        raise AssertionError(f"[obs serve {tag}] telemetry disagrees with "
                             f"the engine: {bad}")
    print(f"[obs serve {tag}] serve/* counters equal stats "
          f"({ {k: engine.stats[k] for k in engine._SCALAR_STATS} }); "
          f"calls {dict(calls)}; spans fold_step {spans['run']}, "
          f"recycle_step {spans['serve']}, admit "
          f"{len(tr.spans('admit'))}, harvest {len(tr.spans('harvest'))}; "
          f"report gauges {gauges if calls['serve'] else 'none yet'}",
          flush=True)


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


def serve_per_cycle(cfg) -> dict:
    """K1 and K3 launches of one serving sample-cycle."""
    return {"evo_attention_fwd": 4 * cfg.n_evoformer
            + 3 * cfg.n_extra_msa_blocks,
            "triangle_mult_fwd": 2 * (cfg.n_evoformer
                                      + cfg.n_extra_msa_blocks)}


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
    want = {k: 0 for k in counts}     # serving launches no backward kernel
    want.update({k: n * sample_cycles
                 for k, n in serve_per_cycle(cfg).items()})
    assert counts == want, f"launches {counts} != path's {want}"
    return sample_cycles


# ---------------------------------------------------------------------------
# Phase 6: where a main-path step's time goes
# ---------------------------------------------------------------------------

_K2_PREP = "K2 prep (delta, do_raw, dgate; bias copy)"
_K2_SUMS = "K2 partial sums (dbias; dq past one key window)"
_K3_PROJ = "K3 gated projections"
_K3_OUT = "K3 LayerNorm + out-projection + gate"
_K4_ROWS = "K4 triangle_mult_bwd_epilogue (per-pair pass)"
_K4_SUMS = "K4 dW_o / dW_g split-K products and partial sums"
_K45_SUMS = "K4 / K5 fp32 gradient sums over rows and chunks"
_K5_PROJ = "K5 ds split + gated projections"
_K5_ROWS = "K5 dx / dW / db"
_GEMM = "GEMM (cuBLAS)"
# the device kernels by a substring of their names, the first match
# deciding: (substring, profile family, the wrapper that launches this
# kernel exactly once a call on its dtype's path, else None).  K2, K3, K4
# and K5 are grouped by stage, their fp32 CUDA-core kernels with the same
# stages; K1 and K6 are one kernel each.  A wrapper's launches in a
# profiler trace are its signature kernels' count (``profiled_launches``).
KERNEL_NAMES = (
    ("flash_attention_fwd", "K6 flash_attention_fwd", "flash_attention_fwd"),
    ("evo_attention_fwd", "K1 evo_attention_fwd", "evo_attention_fwd"),
    ("evo_bwd_prep", _K2_PREP, None),
    ("evo_bwd_bias_pack", _K2_PREP, None),
    ("evo_bwd_dbias_sum", _K2_SUMS, None),
    ("evo_bwd_dq_sum", _K2_SUMS, None),
    ("evo_bwd_dq", "K2 dq + dbias", None),
    ("evo_bwd_dkv", "K2 dk / dv", "evo_attention_bwd"),
    ("tri_proj_f32", _K5_PROJ, None),
    ("tri_dx_split", _K5_PROJ, None),
    ("tri_dx_proj", _K5_PROJ, None),
    ("tri_dx_contract", "K5 contraction (+ dh)", None),
    ("tri_dx_rows", _K5_ROWS, "triangle_mult_bwd_dx"),        # fp32
    ("tri_dx_sums", _K5_ROWS, "triangle_mult_bwd_dx"),        # bf16
    ("tri_dx_out", _K5_ROWS, None),
    ("tri_dx_dw", _K5_ROWS, None),
    ("tri_epi_dw", _K4_SUMS, None),
    ("tri_epi_sums", _K4_SUMS, "triangle_mult_bwd_epilogue"),  # bf16
    ("tri_epi_bwd_rows", _K4_ROWS, "triangle_mult_bwd_epilogue"),  # fp32
    ("tri_epi", _K4_ROWS, None),
    ("outer_acc", _K45_SUMS, None),
    ("col_sum", _K45_SUMS, None),
    ("sum_chunks", _K45_SUMS, None),
    ("tri_fwd_proj", _K3_PROJ, None),
    ("tri_proj", _K3_PROJ, None),
    ("tri_fwd_contract", "K3 contraction", None),
    ("tri_contract", "K3 contraction + epilogue (fp32)", "triangle_mult_fwd"),
    ("tri_fwd_out", _K3_OUT, "triangle_mult_fwd"),            # bf16
    ("gemm", _GEMM, None),
    ("cutlass", _GEMM, None),
    ("nvjet", _GEMM, None),
    ("xmma", _GEMM, None))


def kernel_entry(name: str) -> tuple:
    """The KERNEL_NAMES entry of a device kernel, by its name."""
    n = name.lower()
    for entry in KERNEL_NAMES:
        if entry[0] in n:
            return entry
    return ("", "other (elementwise, reductions, copies)", None)


def kernel_family(name: str) -> str:
    """Profile family of a device kernel, by its name (KERNEL_NAMES)."""
    return kernel_entry(name)[1]


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
    """Run ``work`` once plain and once under torch.profiler, armed by the
    port's ``ProfileWindow``.  Prints both walls, the device's busy time
    (union of kernel intervals) and its idle share of the profiled wall,
    device time by kernel family and the top kernels; returns the device ms
    by family.  The Chrome trace goes to build/profile/<tag>/."""
    from repro_torch.obs import ProfileWindow

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    wall_plain = run()
    window = ProfileWindow(0, 1, str(ROOT / "build" / "profile" / tag),
                           device="cuda")
    window.maybe_start(0)
    wall_prof = run()
    window.maybe_stop(0)
    if window.trace_path is None:
        raise AssertionError(f"[profile {tag}] torch.profiler wrote no trace")
    events = json.loads(pathlib.Path(window.trace_path).read_text())[
        "traceEvents"]
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
# Phase 5b: continuous serving (FoldEngine.serve)
# ---------------------------------------------------------------------------

# the traffic: Poisson arrivals at SERVE_RATE a virtual second from seed 1,
# deadlines SERVE_SLACK virtual seconds after arrival, every third request
# at priority 1; two requests repeat requests 0 and 1 SERVE_REPEAT_AFTER
# virtual seconds after the last of the others, so both are cache hits
SERVE_RATE, SERVE_SLACK, SERVE_REPEAT_AFTER = 4.0, 3.0, 10.0
SERVE_OPTS = dict(featurize_workers=2, starvation_steps=4)
SERVE_CACHE = 64


def serve_traffic(cfg) -> list:
    """Phase 5b's 10 requests: ``make_fold_requests(cfg, 8, seed=1)`` plus
    repeats of requests 0 and 1, stamped as SERVE_* says."""
    from repro_torch.data.synthetic import make_fold_requests
    reqs = make_fold_requests(cfg, 8, seed=1)
    rng = np.random.default_rng(1)
    t, out = 0.0, []
    for r in reqs:
        t += float(rng.exponential(1.0 / SERVE_RATE))
        out.append(dataclasses.replace(r, arrival_s=t,
                                       deadline_s=t + SERVE_SLACK,
                                       priority=int(r.rid % 3 == 0)))
    for rid, src in ((8, out[0]), (9, out[1])):
        at = t + SERVE_REPEAT_AFTER
        out.append(dataclasses.replace(src, rid=rid, arrival_s=at,
                                       deadline_s=at + SERVE_SLACK,
                                       priority=int(rid % 3 == 0)))
    return out


def serve_run(engine, traffic, policy: str) -> dict:
    """One ``engine.serve`` of ``traffic`` (a fresh clock and cache,
    measured step costs) with the launch counters set to 0 just before and
    read just after; its results, report, launches, wall and memory."""
    from repro_torch.kernels import ops
    from repro_torch.serve.result_cache import ResultCache
    from repro_torch.serve.scheduler import VirtualClock
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.serve([dataclasses.replace(r) for r in traffic],
                        policy=policy, clock=VirtualClock(),
                        cache=ResultCache(SERVE_CACHE), **SERVE_OPTS)
    torch.cuda.synchronize()
    return {"done": done, "report": engine.last_report,
            "launches": ops.launch_counts(),
            "wall": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30}


def host_carry_bytes(cfg, bucket, slots: int) -> int:
    """Bytes the reference moves between host and device in one recycle
    step of ``bucket`` (``repro/serve/scheduler.py:244-247``): the lane's
    features and its fp32 carry in, the carry and every output out."""
    r, s, se = bucket.n_res, bucket.n_seq, bucket.n_extra_seq
    feats = 4 * (s * r * cfg.msa_feat_dim + se * r * cfg.msa_feat_dim
                 + r * cfg.target_feat_dim + r + r + s + se)
    carry = 4 * (r * cfg.c_m + r * r * cfg.c_z + r * 3
                 + r * cfg.structure.c_s) + 1 + 4 + 1
    outs = 4 * (r * 3 + r + r * r + r * cfg.n_plddt_bins
                + r * r * cfg.n_distogram_bins + 1) + 1
    return slots * (feats + 2 * carry + outs)


def check_serve_results(cfg, traffic, run, per_cycle: dict) -> int:
    """Every request served, the repeats (rids 8, 9) from the cache, each
    fold finite; the launches equal ``per_cycle`` times the sample-cycles
    the served requests ran, no other kernel launched.  Returns those
    sample-cycles."""
    from repro_torch.serve import fold_steps as fs
    done = run["done"]
    if sorted(done) != [r.rid for r in traffic]:
        raise AssertionError(f"served {sorted(done)}")
    hits = sorted(rid for rid, res in done.items() if res.cache_hit)
    if hits != [8, 9]:
        raise AssertionError(f"cache hits {hits}, not the repeats [8, 9]")
    cycles = 0
    for r in traffic:
        res = done[r.rid]
        n = fs.request_shapes(r.features)[0]
        if not (res.coords.shape == (n, 3) and np.isfinite(res.coords).all()
                and 0.0 <= res.plddt.min() <= res.plddt.max() <= 100.0):
            raise AssertionError(f"request {r.rid}: malformed fold")
        if not res.cache_hit:
            cycles += res.n_recycles
    want = {k: 0 for k in run["launches"]}
    want.update({k: n * cycles for k, n in per_cycle.items()})
    if run["launches"] != want:
        raise AssertionError(f"launches {run['launches']} != the path's "
                             f"{want}")
    return cycles


def same_folds(a: dict, b: dict, what: str, src=None) -> None:
    """``a``'s folds equal ``b``'s bit for bit (coordinates, pLDDT,
    recycles); ``src`` maps a rid of ``a`` to the rid of ``b`` it
    repeats."""
    for rid, res in a.items():
        other = b[(src or {}).get(rid, rid)]
        if not (np.array_equal(res.coords, other.coords)
                and np.array_equal(res.plddt, other.plddt)
                and res.n_recycles == other.n_recycles):
            raise AssertionError(f"{what}: request {rid} differs")


def admission_invariant(engine, traffic) -> dict:
    """A request served alone against the same request with a second one
    of its bucket admitted into its lane after its second step, under
    injected costs of 1 virtual second a step: its fold, recycles and
    finish time must not move."""
    from repro_torch.serve.scheduler import VirtualClock
    a = next(r for r in traffic if r.rid == 0)
    b = next(r for r in traffic if r.rid == 3)
    a = dataclasses.replace(a, arrival_s=0.0, deadline_s=None)
    b = dataclasses.replace(b, arrival_s=1.5, deadline_s=None)
    cost = {bk: 1.0 for bk in engine.buckets}
    solo = engine.serve([a], clock=VirtualClock(), step_cost=cost)[0]
    both = engine.serve([a, b], clock=VirtualClock(), step_cost=cost)
    admitted = [t["admitted"] for t in engine.last_report["trace"]]
    if admitted[:3] != [[0], [], [3]] or both[0].bucket != both[3].bucket:
        raise AssertionError(f"request 3 was not admitted mid-flight into "
                             f"request 0's lane: {admitted}")
    same_folds({0: both[0]}, {0: solo}, "mid-flight admission")
    if not (solo.finish_s == both[0].finish_s
            and solo.n_recycles == both[0].n_recycles):
        raise AssertionError("a mid-flight admission moved the request in "
                             "flight")
    return {"finish_s": solo.finish_s, "n_recycles": solo.n_recycles}


def serve_report(tag: str, cfg, engine, run, cycles: int) -> dict:
    rep = run["report"]
    steps = max(rep["steps"], 1)
    walls = {b.n_res: round(float(np.median(w)), 4)
             for b, w in sorted(rep["step_wall_s"].items())}
    by_bucket = collections.Counter(t["bucket"] for t in rep["trace"])
    ref_bytes = sum(n * host_carry_bytes(cfg, b, engine.slots_for(b))
                    for b, n in by_bucket.items())
    tb = rep["transfer_bytes"]
    row = {"p50_ms": rep["p50_ms"], "p99_ms": rep["p99_ms"],
           "mean_ms": rep["mean_ms"], "goodput_rps": rep["goodput_rps"],
           "on_time_frac": rep["on_time_frac"],
           "utilization": rep["utilization"], "stage_ms": rep["stage_ms"],
           "steps": rep["steps"], "forced_admissions":
           rep["forced_admissions"], "hit_rate": rep["hit_rate"],
           "median_step_wall_s_by_bucket_r": walls,
           "steps_by_bucket_r": {b.n_res: n
                                 for b, n in sorted(by_bucket.items())},
           "h2d_bytes_per_step": tb["h2d"] / steps,
           "d2h_bytes_per_step": tb["d2h"] / steps,
           "host_carry_bytes_per_step": ref_bytes / steps,
           "sample_cycles": cycles, "wall_s": run["wall"],
           "peak_gib": run["peak_gib"], "reserved_gib": run["reserved_gib"],
           "featurize_stats": rep["featurize_stats"]}
    print(f"[serve {tag}] af2_initial ({cfg.n_evoformer}+"
          f"{cfg.n_extra_msa_blocks} blocks), {rep['requests']} "
          f"requests at {SERVE_RATE} req/s (virtual), measured step costs "
          f"(smoke readings: too few requests at too light a load to "
          f"compare policies): {json.dumps(row)}; launches "
          f"{run['launches']}", flush=True)
    return row


# phase 5b (d): long_plan routing over two gloo ranks sharing the card
LONG_DEPTH = (16, 4)
LONG_MAX_RECYCLE = 2
# the DAP results against the one-device engine's: relative L2 difference
# of coordinates and of pLDDT (phase 9c's bound on losses)
LONG_RTOL = 2e-3


def long_plan_cfg(cfg):
    return dataclasses.replace(cfg, n_evoformer=LONG_DEPTH[0],
                               n_extra_msa_blocks=LONG_DEPTH[1])


def long_plan_setup(cfg):
    """(requests, bucket table, injected step costs, the indivisible
    bucket): one request in each default bucket, all arriving at 0; the
    table adds an r-257 bucket no request fits first."""
    from repro_torch.data.synthetic import make_fold_requests
    from repro_torch.serve import fold_steps as fs
    buckets = fs.default_buckets(cfg)
    bad = fs.Bucket(cfg.n_res + 1, cfg.n_seq, cfg.n_extra_seq)
    reqs = make_fold_requests(cfg, 3, seed=2, fracs=(0.2, 0.4, 1.0))
    cost = {b: 0.1 * (i + 1) for i, b in enumerate(buckets + [bad])}
    return reqs, buckets + [bad], cost, bad


@contextlib.contextmanager
def record_k1_shapes(engine):
    """Within the block, count K1's (bucket r, lead rows, keys) at every
    launch of ``engine``'s recycle steps (the K1 wrapper and the engine's
    ``recycle_step_for`` are wrapped, and restored after)."""
    from repro_torch.kernels import evo_attention as ka
    seen, cur = collections.Counter(), {}
    launch = ka.evo_attention_fwd

    def counted(q, *args, **kw):
        seen[cur["r"], q.shape[0], q.shape[1]] += 1
        return launch(q, *args, **kw)

    make = engine.recycle_step_for

    def tagged(bucket):
        step = make(bucket)

        def run(*args):
            cur["r"] = bucket.n_res
            return step(*args)
        return run

    ka.evo_attention_fwd = counted
    engine.recycle_step_for = tagged
    try:
        yield seen
    finally:
        ka.evo_attention_fwd = launch
        del engine.recycle_step_for


def long_plan_engine(cfg, dev, buckets, **kw):
    from repro_torch.serve.fold_engine import FoldEngine
    return FoldEngine(cfg, seeded_model(cfg, seed=0), buckets=buckets,
                      micro_batch=2, max_recycle=LONG_MAX_RECYCLE, tol=0.0,
                      device=dev, graphs=False, **kw)


def long_plan_serve(engine, reqs, cost) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.parallel import collectives as coll
    from repro_torch.serve.scheduler import VirtualClock
    _sync(engine.device)
    ops.reset_launch_counts()
    coll.reset_counts()
    t0 = time.perf_counter()
    with record_k1_shapes(engine) as shapes:
        done = engine.serve(reqs, clock=VirtualClock(), step_cost=cost)
        _sync(engine.device)
    wall = time.perf_counter() - t0
    return {"results": {rid: (r.coords, r.plddt, r.n_recycles, r.finish_s)
                        for rid, r in done.items()},
            "k1_shapes": dict(shapes), "launches": ops.launch_counts(),
            "collectives": coll.counts(), "wall": wall,
            "step_wall_s": {b.n_res: w for b, w in
                            engine.last_report["step_wall_s"].items()},
            "trace": [(t["t"], t["bucket"].n_res, t["active"], t["admitted"])
                      for t in engine.last_report["trace"]]}


def long_plan_rank(rank, world, dev, cfg):
    """One rank of phase 5b (d): the 3 requests through an engine whose
    short buckets run data=2 and whose r-256 bucket runs dap=2; then the
    indivisible bucket must raise PlanError before any collective, and
    graphs=True must raise under gloo."""
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.plan import ParallelPlan, PlanError
    from repro_torch.serve.fold_engine import FoldEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    reqs, buckets, cost, bad = long_plan_setup(cfg)
    kw = dict(plan=ParallelPlan(data=2), long_plan=ParallelPlan(dap=2),
              long_threshold=cfg.n_res)
    engine = long_plan_engine(cfg, dev, buckets, **kw)
    out = long_plan_serve(engine, reqs, cost)
    before = coll.counts()
    for make in (engine.recycle_step_for, engine.step_for):
        try:
            make(bad)
        except PlanError as e:
            out.setdefault("plan_errors", []).append(str(e))
    out["collectives_at_error"] = coll.counts() == before
    try:
        FoldEngine(cfg, engine.params, buckets=buckets, device=dev,
                   graphs=True, **kw)
    except ValueError as e:
        out["graphs_error"] = str(e)
    # the short buckets on one device per rank, measured step costs: the
    # ranks agree every step's wall, so their schedules stay equal
    out["replicated"] = long_plan_serve(
        long_plan_engine(cfg, dev, buckets[:-1], long_plan=kw["long_plan"],
                         long_threshold=cfg.n_res), reqs, None)
    return out


def long_plan_phase(cfg, dev) -> dict:
    """Phase 5b (d).  A one-device eager engine of the same depth serves
    the requests here; then two rank processes on this card over gloo,
    held to it."""
    from repro_torch.parallel import ranks as ranks_lib
    from repro_torch.serve import fold_steps as fs
    lcfg = long_plan_cfg(cfg)
    reqs, buckets, cost, bad = long_plan_setup(lcfg)
    ref = long_plan_serve(long_plan_engine(lcfg, dev, buckets), reqs, cost)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = ranks_lib.spawn(long_plan_rank, 2, lcfg, device_type=dev.type,
                            backend="gloo", timeout_s=600)
    spawn_s = time.perf_counter() - t0
    top = lcfg.n_res
    want_shapes = collections.Counter()
    for (r, lead, keys), n in ref["k1_shapes"].items():
        if r == top:
            want_shapes[r, lead // 2, keys] += n
    d_max, rel = 0.0, 0.0
    for rank, got in enumerate(ranks):
        shapes = {k: n for k, n in got["k1_shapes"].items() if k[0] == top}
        if shapes != dict(want_shapes):
            raise AssertionError(f"rank {rank}: K1 shapes of the r-{top} "
                                 f"bucket {shapes}, not the one-device "
                                 f"shapes at half the lead rows "
                                 f"{dict(want_shapes)}")
        if len(got.get("plan_errors", [])) != 2 \
                or not got["collectives_at_error"]:
            raise AssertionError(f"rank {rank}: the indivisible bucket "
                                 f"{bad} did not raise PlanError before any "
                                 f"collective: {got.get('plan_errors')}")
        if "graphs_error" not in got:
            raise AssertionError("graphs=True under gloo ranks did not raise")
        for run in (got, got["replicated"]):
            for rid, (xyz, plddt, n_rec, _) in ref["results"].items():
                gx, gp, gn, _ = run["results"][rid]
                if gn != n_rec:
                    raise AssertionError(f"rank {rank} request {rid}: {gn} "
                                         f"recycles, one device {n_rec}")
                for a, b in ((gx, xyz), (gp, plddt)):
                    d_max = max(d_max, float(np.abs(a - b).max()))
                    rel = max(rel, float(np.linalg.norm(a - b)
                                         / max(np.linalg.norm(b), 1e-30)))
    rep0, rep1 = (g["replicated"] for g in ranks)
    if rep0["trace"] != rep1["trace"] or \
            rep0["step_wall_s"] != rep1["step_wall_s"]:
        raise AssertionError("under measured costs the ranks' schedules "
                             "differ with the short buckets on one device")
    if not rel <= LONG_RTOL:
        raise AssertionError(f"long_plan folds differ from one device's by "
                             f"{rel} relative L2")
    row = {"depth": list(LONG_DEPTH), "max_recycle": LONG_MAX_RECYCLE,
           "max_abs_diff": d_max, "max_rel_l2": rel,
           "bit_equal": d_max == 0.0, "spawn_s": spawn_s,
           "one_device": {"wall_s": ref["wall"],
                          "step_wall_s": ref["step_wall_s"]},
           "ranks": [{"wall_s": g["wall"], "step_wall_s": g["step_wall_s"],
                      "launches": g["launches"],
                      "collectives": g["collectives"]} for g in ranks],
           "plan_error": ranks[0]["plan_errors"][0],
           "replicated_measured": {
               "steps": len(rep0["trace"]),
               "step_wall_s": rep0["step_wall_s"],
               "wall_s": [g["replicated"]["wall"] for g in ranks]}}
    lengths = [fs.request_shapes(r.features)[0] for r in reqs]
    print(f"[serve long_plan] af2_initial {LONG_DEPTH[0]}+{LONG_DEPTH[1]} "
          f"blocks, 3 requests (r {lengths}), plan data=2, "
          f"long_plan dap=2 from r {top}, two gloo ranks on {dev.type}, "
          f"injected costs; then plan None with measured costs, the ranks' "
          f"schedules equal: {json.dumps(row)}", flush=True)
    return row


def continuous_phase(cfg, dev, engine, per_cycle: dict) -> dict:
    """Phase 5b (a)-(c) on phase 5's graphed engine, then (d)."""
    traffic = serve_traffic(cfg)
    rows, runs = {}, {}
    for policy in ("continuous", "fifo"):
        runs[policy] = serve_run(engine, traffic, policy)
        cycles = check_serve_results(cfg, traffic, runs[policy], per_cycle)
        rows[policy] = serve_report(policy, cfg, engine, runs[policy],
                                    cycles)
    same_folds(runs["continuous"]["done"], runs["fifo"]["done"],
               "continuous vs fifo")
    done = engine.run([r for r in traffic if r.rid < 8])
    same_folds(runs["continuous"]["done"], done, "serve vs run",
               src={8: 0, 9: 1})
    inv = admission_invariant(engine, traffic)
    if engine.compile_misses > 2 * len(engine.buckets):
        raise AssertionError(f"compile_misses {engine.compile_misses} over "
                             f"twice the {len(engine.buckets)} buckets")
    print(f"[serve] continuous vs fifo vs run: bit for bit; mid-flight "
          f"admission leaves the request in flight unchanged "
          f"({json.dumps(inv)}); compile_misses {engine.compile_misses} "
          f"(table {len(engine.buckets)})", flush=True)
    rows["long_plan"] = long_plan_phase(cfg, dev)
    rows["launches"] = runs["continuous"]["launches"]
    return rows

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


# the training runs' seed: its first four draws of n_recycle are 1, 3, 2, 4,
# so a warm-up of four steps captures every draw of 1..4 (seed 0 needs
# twelve); the measured steps draw 3, 1, 4, and steps 7 and 8, the profile's
# plain and profiled runs, both draw 2
TRAIN_SEED = 1502
TRAIN_WARMUP, TRAIN_STEPS = 4, 3


def step_walls(tracer) -> list:
    """Each training step's wall in seconds, in the order the steps ran:
    its ``step`` span, which ends once the card has finished the step."""
    return [e["dur"] / 1e6 for e in tracer.spans("step")]


def train_main_path(cfg, dev, *, graphs: bool, warmup=TRAIN_WARMUP,
                    steps=TRAIN_STEPS, obs=None):
    """TrainRunner at ``cfg`` with its defaults, batch 1, from the seeded
    model (``graphs`` on or off), with a SpanTracer and the registry
    ``obs`` (None: the runner's own): ``warmup`` steps (graphed: they must
    capture every draw of 1..max_recycle), then ``steps`` steps with the
    launch counters set to 0 just before and read just after, each step
    checked.  Returns (runner, launch counts, gradient norms, peak
    allocated GiB of the measured steps, reserved GiB after them)."""
    from repro_torch.kernels import ops
    from repro_torch.obs import SpanTracer
    from repro_torch.train.trainer import TrainRunner
    model = seeded_model(cfg, seed=0).to(dev)
    runner = TrainRunner(cfg, batch_size=1, seed=TRAIN_SEED, device=dev,
                         model=model, graphs=graphs, obs=obs,
                         tracer=SpanTracer())
    tag = "graphed" if graphs else "eager"
    for _ in range(warmup):
        built = runner.train_compiles
        runner.run(runner.step + 1)
        print(f"[train warm-up {tag}] step {runner.step - 1}, n_recycle "
              f"{runner.history['n_recycle'][-1]}: "
              f"{step_walls(runner.tracer)[-1]:.3f} s"
              + (" (eager run + capture)" if graphs and
                 runner.train_compiles > built else ""), flush=True)
    if graphs and runner.train_compiles != runner.max_recycle:
        raise AssertionError(f"warm-up captured {runner.train_compiles} of "
                             f"{runner.max_recycle} draws")
    torch.cuda.synchronize()
    print(f"[train memory {tag}] after the warm-up: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved",
          flush=True)
    before = {k: p.detach().clone() for k, p in runner.model.named_parameters()}
    ema_before = {k: e.clone() for k, e in runner.state["ema"].items()}
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
    reserved_gib = torch.cuda.memory_reserved() / 2 ** 30
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
    return runner, counts, norms, peak_gib, reserved_gib


def train_report(tag, runner, counts, norms, peak, reserved,
                 warmup=TRAIN_WARMUP):
    step_s = step_walls(runner.tracer)[warmup:]
    print(f"[train path {tag}] af2_initial (48+4 blocks) TrainRunner, batch "
          f"1: steps {list(range(warmup, runner.step))}, n_recycle "
          f"{runner.history['n_recycle'][warmup:]}, losses "
          f"{[round(x, 4) for x in runner.history['loss'][warmup:]]}, "
          f"gradient norms before the 0.1 clip "
          f"{[round(x, 4) for x in norms]}; step latency "
          f"{[round(x, 3) for x in step_s]} s = "
          f"{len(step_s) / sum(step_s):.3f} proteins/s; train_compiles "
          f"{runner.train_compiles}; peak memory {peak:.2f} GiB allocated, "
          f"{reserved:.2f} GiB reserved; launches {counts}", flush=True)


def train_diff(a, b) -> dict:
    """Max |diff| of two runners' losses (every step), parameters and EMA."""
    return {
        "loss": max(abs(x - y) for x, y in zip(a.history["loss"],
                                                 b.history["loss"])),
        "params": max((p - q).abs().max().item() for p, q in
                      zip(a.model.parameters(), b.model.parameters())),
        "ema": max((a.state["ema"][k] - b.state["ema"][k]).abs().max().item()
                   for k in a.state["ema"])}


def evaluate_timed(runner) -> tuple:
    """(``runner.evaluate()``, its wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = runner.evaluate()
    torch.cuda.synchronize()
    return ev, time.perf_counter() - t0


def check_evaluation(ev, runner) -> None:
    """Finite coordinates of every held-out protein, lDDT-Cα in [0, 100]."""
    per = ev["per_sample"]
    n = runner.eval_batches * runner.eval_batch_size
    if not (per.shape == (n,) and np.isfinite(per).all()
            and per.min() >= 0.0 and per.max() <= 100.0
            and ev["coords"].shape == (n, runner.cfg.n_res, 3)
            and np.isfinite(ev["coords"]).all()):
        raise AssertionError(f"evaluation: lDDT-Cα {per}, coords "
                             f"{ev['coords'].shape}")


# ---------------------------------------------------------------------------
# Phase 9's telemetry part: registry, spans, torch.profiler, attribution
# ---------------------------------------------------------------------------

# the graphed runner's steps with its file sinks and tracer (an evaluation
# after step OBS_EVAL_EVERY - 1, torch.profiler over step OBS_PROFILE, a
# checkpoint at the end), TRAIN_SEED drawing 2, 4, 2, 2, 4, 3; then steps
# OBS_MIX, one run call each, with the file sinks and tracer at every
# other step of a draw and without them at the rest: draws 2, 2, 4, 1, 4,
# 2, 2, 3, 4, 3, 1, 3, 2, 4, 3
OBS_ON, OBS_MIX = (9, 15), (15, 30)
OBS_EVAL_EVERY, OBS_PROFILE = 12, 12
TRAIN_SPANS = ("featurize", "device_put", "input_wait", "step", "eval",
               "checkpoint")


def check_span_order(tracer) -> None:
    """Spans nest: a span of depth d > 0 lies inside a span of depth d - 1
    on its thread, spans of depth 0 on a thread do not overlap; and each
    step's input (its ``input_wait`` and ``device_put`` spans) is in hand
    before its ``step`` span starts."""
    spans = tracer.spans()
    by_tid = collections.defaultdict(list)
    for e in spans:
        by_tid[e["tid"]].append(e)
    eps = 1e-3     # microseconds of float rounding
    for evs in by_tid.values():
        top = sorted((e for e in evs if e["args"]["depth"] == 0),
                     key=lambda e: e["ts"])
        for a, b in zip(top, top[1:]):
            if b["ts"] < a["ts"] + a["dur"] - eps:
                raise AssertionError(f"spans overlap: {a} {b}")
        for e in evs:
            d = e["args"]["depth"]
            if d and not any(
                    p["args"]["depth"] == d - 1 and p["ts"] <= e["ts"] + eps
                    and e["ts"] + e["dur"] <= p["ts"] + p["dur"] + eps
                    for p in evs):
                raise AssertionError(f"span outside its parent: {e}")
    start = {}
    for e in tracer.spans("step"):
        start.setdefault(e["args"]["step"], e["ts"])
    for e in spans:
        s = e["args"].get("step")
        if e["name"] in ("input_wait", "device_put") and s in start and \
                e["ts"] + e["dur"] > start[s] + eps:
            raise AssertionError(f"{e['name']} of step {s} ends after the "
                                 f"step starts")


def profiled_launches(path, wrappers) -> dict:
    """Launches of each of ``wrappers`` in a torch.profiler trace: the
    count of its signature kernels in KERNEL_NAMES."""
    events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    seen = collections.Counter(kernel_entry(e["name"])[2] for e in events
                               if e.get("cat") == "kernel")
    return {k: seen[k] for k in wrappers}


def obs_part(runner, mem, obs_dir, dev) -> dict:
    """Phase 9's telemetry part on the graphed runner, which phase 9 built
    with a registry (``mem`` and a JSONL file in ``obs_dir``) and a
    SpanTracer: steps OBS_ON with one evaluation, one checkpoint and a
    ProfileWindow over step OBS_PROFILE.  Checks the history views, the
    sink rows, the spans, the ckpt/* series and data/* gauges, the JSONL
    rows, the profiled step's K1-K5 launches and the attribution row;
    prints the attribution.  Then steps OBS_MIX with and without the file
    sinks and the tracer, interleaved within each draw (:func:`obs_mix`),
    and prints their walls."""
    from repro_torch.analysis.roofline import predict_step_time
    from repro_torch.obs import ProfileWindow
    from repro_torch.train.checkpoint import CheckpointManager
    obs, tracer, hist = runner.obs, runner.tracer, runner.history
    if runner.step != OBS_ON[0]:
        raise AssertionError(f"the runner is at step {runner.step}")
    runner.eval_every = OBS_EVAL_EVERY
    runner.mgr = CheckpointManager(f"{obs_dir}/ckpt", keep=1,
                                   plan_meta=runner.built.metadata(),
                                   obs=obs)
    runner.profile_window = ProfileWindow(OBS_PROFILE, OBS_PROFILE + 1,
                                          f"{obs_dir}/profile", device=dev)
    t0 = time.perf_counter()
    runner.run(OBS_ON[1])
    t_on = time.perf_counter() - t0
    prof_path = runner.profile_window.trace_path
    runner.profile_window, runner.mgr, runner.eval_every = None, None, 0
    obs.flush()
    t0 = time.perf_counter()

    bad = []
    keys = ("loss", "n_recycle", "step_s", "eval", "data", "attribution")
    if any(hist[k] is not obs.series(f"train/{k}") for k in keys):
        bad.append("history is not the registry's series")
    n_on = OBS_ON[1]
    if [r["value"] for r in mem.events("train/loss")] != hist["loss"][:n_on]:
        bad.append("train/loss rows differ from history")
    steps = [(e["args"]["step"], e["args"]["n_recycle"])
             for e in tracer.spans("step")]
    if steps != list(enumerate(hist["n_recycle"][:n_on])):
        bad.append(f"step spans {steps}")
    names = collections.Counter(e["name"] for e in tracer.spans())
    main_tid = tracer.spans("step")[0]["tid"]
    if not (all(names[k] for k in TRAIN_SPANS) and names["eval"] == 1
            and names["checkpoint"] == 1
            and all(e["tid"] != main_tid for e in tracer.spans("featurize"))):
        bad.append(f"spans {dict(names)}")
    check_span_order(tracer)
    snap = obs.snapshot()
    gauges = {k: snap[k]["value"] for k in snap if k.startswith("data/")}
    ckpt = {k: list(obs.series(f"ckpt/{k}"))
            for k in ("snapshot_s", "save_s")}
    if len(gauges) != 6 or any(len(v) != 1 for v in ckpt.values()):
        bad.append(f"data gauges {gauges}, ckpt series {ckpt}")
    path = pathlib.Path(obs_dir) / "metrics.jsonl"
    rows = [json.loads(ln) for ln in path.read_text().splitlines()]
    seqs = [r["seq"] for r in rows]
    if not all(b > a for a, b in zip(seqs, seqs[1:])) or \
            len(rows) != len(mem.rows):
        bad.append(f"JSONL: {len(rows)} rows against {len(mem.rows)}")
    nr_prof = runner.recycle_draw(OBS_PROFILE)
    want = train_launches(runner.cfg, nr_prof)
    seen = profiled_launches(prof_path, want) if prof_path else {}
    if seen != want:
        bad.append(f"profiled step {OBS_PROFILE}: launches {seen} != {want}")
    attr = hist["attribution"]
    if not (len(attr) == 1 and 0.0 < attr[0]["mfu"] <= 1.0):
        bad.append(f"attribution {attr}")
    if bad:
        raise AssertionError(f"[obs train] {bad}")
    t_check = time.perf_counter() - t0

    span_s = {e["args"]["step"]: e["dur"] / 1e6 for e in tracer.spans("step")}
    two = [st for st in range(*OBS_ON)
           if st != OBS_PROFILE and runner.recycle_draw(st) == 2]
    measured = float(np.median([span_s[st] for st in two]))
    pred = predict_step_time(runner.cfg, n_recycle=2)
    flops = pred["model_flops_per_step"]
    row = {"n_recycle": 2, "steps": two,
           "model_flops_per_step": flops,
           "predicted_ms": 1e3 * pred["predicted_step_s"],
           "measured_ms": 1e3 * measured,
           "measured_over_predicted": measured / pred["predicted_step_s"],
           "mfu": flops / measured / PEAK_BF16_FLOPS,
           "runner_row": {k: attr[0][k] for k in (
               "step", "n_recycle", "measured_step_s", "predicted_step_s",
               "measured_over_predicted", "mfu", "goodput", "stall_fraction",
               "overhead_fraction")}}
    print(f"[obs train] steps {OBS_ON[0]}-{OBS_ON[1] - 1} with MemorySink, "
          f"JsonlSink and SpanTracer: history is six live series; "
          f"{len(rows)} JSONL rows ({path.stat().st_size} bytes), seq "
          f"increasing; spans {dict(names)}; ckpt s {json.dumps(ckpt)}; "
          f"data gauges {json.dumps(gauges)}; seconds: steps "
          f"{OBS_ON[0]}-{OBS_ON[1] - 1} with the evaluation, checkpoint and "
          f"profile {t_on:.1f}, the checks {t_check:.1f}", flush=True)
    print(f"[obs profile] step {OBS_PROFILE} (n_recycle {nr_prof}) under "
          f"torch.profiler (CPU + CUDA): "
          f"{pathlib.Path(prof_path).stat().st_size} bytes of trace; K1-K5 "
          f"launches {json.dumps(seen)}, as the draw implies", flush=True)
    print(f"[obs attribution] af2_initial graphed, batch 1: n_recycle 2 "
          f"(steps {two}, span walls): {flops:.4g} model FLOPs a "
          f"step, predicted {row['predicted_ms']:.2f} ms, measured "
          f"{row['measured_ms']:.1f} ms, measured / predicted "
          f"{row['measured_over_predicted']:.1f}, MFU {row['mfu']:.4f} of "
          f"989 TFLOP/s; the runner's row at its evaluation (mean of the "
          f"watchdog's EMA over steps {OBS_ON[0]}-{OBS_EVAL_EVERY - 1}, "
          f"mean n_recycle): {json.dumps(row['runner_row'])}", flush=True)
    over = obs_mix(runner)
    return dict(row, overhead=over, profiled=seen)


def obs_mix(runner) -> dict:
    """Steps OBS_MIX of the graphed runner, one ``run`` call each: at the
    1st, 3rd, ... step of each draw with the registry's file sinks and
    the runner's tracer, at the 2nd, 4th, ... without them.  A step's wall
    runs from its start (the watchdog's clock) to the end of its
    ``obs.tick``, so it holds the span, the rows the sinks write and the
    tick.  Prints each draw's walls with and without, their medians'
    ratio, and the spread; returns them."""
    obs, tracer = runner.obs, runner.tracer
    sinks = list(obs.sinks)
    walls = {}
    tick = obs.tick

    def timed_tick(step=None):
        out = tick(step=step)
        walls[step] = time.perf_counter() - runner.watchdog._t0
        return out
    obs.tick = timed_tick
    seen = collections.Counter()
    by_draw = collections.defaultdict(lambda: ([], []))
    t0 = time.perf_counter()
    try:
        for st in range(*OBS_MIX):
            nr = runner.recycle_draw(st)
            on = seen[nr] % 2 == 0
            seen[nr] += 1
            obs.sinks = sinks if on else []
            runner.tracer = tracer if on else None
            runner.run(st + 1)
            walls.pop(st + 1, None)     # run's closing tick, not a step's
            by_draw[nr][0 if on else 1].append(st)
    finally:
        obs.sinks, runner.tracer = sinks, tracer
        del obs.tick
    t_mix = time.perf_counter() - t0
    over = {}
    for nr, (on, off) in sorted(by_draw.items()):
        if on and off:
            w_on = [walls[st] for st in on]
            w_off = [walls[st] for st in off]
            over[nr] = {"with": [round(w, 4) for w in w_on],
                        "without": [round(w, 4) for w in w_off],
                        "median_ratio": float(np.median(w_on)
                                              / np.median(w_off)),
                        "spread_with": round(max(w_on) - min(w_on), 4),
                        "spread_without": round(max(w_off) - min(w_off), 4)}
    print(f"[obs overhead] steps {OBS_MIX[0]}-{OBS_MIX[1] - 1}, graphed, one "
          f"run call each, with the file sinks and tracer at every other "
          f"step of a draw and without them at the rest; step walls (step "
          f"start to the end of its tick) by draw: {json.dumps(over)}; "
          f"{t_mix:.1f} s (the reference's budget: 2%; printed, not gated)",
          flush=True)
    return over


# ---------------------------------------------------------------------------
# Phase 9c: the training step under BP, DAP and BP x DAP plans
# ---------------------------------------------------------------------------

def dap_train_shapes(cfg, d: int = 2):
    """The shapes a DAP-``d`` rank gives K1 / K2 in the af2_initial
    training step: the serial shapes with 1/d of the lead rows (the bias
    heads gathered to full S), and launches per sample-cycle of one rank."""
    att, _ = train_shapes(cfg)
    return [(f"dap{d}_{name}", (L // d, S, H, C), per, biased)
            for name, (L, S, H, C), per, biased in att if per]


def check_triangle_dap(dev, r: int, d: int, c_z: int, c: int, per: int,
                       dtype=torch.bfloat16):
    """K3 (with s), K4 and K5 (both operand sides) at a DAP-``d`` rank's
    shapes: xa and xg r/d rows of the LayerNorm'd pair rep, xb all r rows
    (outgoing: the shard's rows and every row; incoming: the shard's
    columns and every column, as transposed views), against their plain
    versions; times and bounds per call.  ``per``: K4 launches per
    sample-cycle of one rank (K3 and K5 twice that)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import triangle as kt
    g = torch.Generator(device=dev).manual_seed(9)
    ri, el = r // d, 2
    rows = []
    for outgoing in (True, False):
        x = _rand(g, (r, r, c_z), dtype)
        w = (_rand(g, (c_z, 2 * c), dtype, c_z ** -0.5),
             _rand(g, (2 * c,), dtype, 0.5),
             _rand(g, (c_z, 2 * c), dtype, c_z ** -0.5),
             _rand(g, (2 * c,), dtype, 0.5),
             (1 + _rand(g, (c,), torch.float32, 0.1)).to(dtype),
             _rand(g, (c,), dtype, 0.1), _rand(g, (c, c_z), dtype, c ** -0.5),
             _rand(g, (c_z,), dtype, 0.1),
             _rand(g, (c_z, c_z), dtype, c_z ** -0.5),
             _rand(g, (c_z,), dtype, 0.5))
        w_a, b_a, w_b, b_b, ln_s, ln_b, w_o, b_o, w_g, b_g = w
        xg = x[:ri]
        if outgoing:
            xa, xb = xg, x
        else:
            xa, xb = x[:, :ri].transpose(0, 1), x.transpose(0, 1)
        dy = _rand(g, (ri, r, c_z), dtype)
        y, s_k = kt.triangle_mult_fwd(xa, xb, xg, *w, return_s=True)
        y_r, s_r = ref.triangle_mult_ref(xa, xb, xg, *w, return_s=True)
        pa = ref.gated_projection(xa, w_a, b_a).to(dtype).float().abs()
        pb = ref.gated_projection(xb, w_b, b_b).to(dtype).float().abs()
        extra = 2.0 ** -7 * torch.einsum("ikc,jkc->ijc", pa, pb)
        name = f"dap{d}_" + ("outgoing" if outgoing else "incoming")
        err3 = max(check_close(y, y_r, f"K3 {name}"),
                   check_grad_close(s_k, s_r, f"K3 s {name}", extra))
        del pa, pb, extra
        epi = kt.triangle_mult_bwd_epilogue(s_r, xg, dy, ln_s, ln_b, w_o, b_o,
                                            w_g, b_g)
        epi_r = ref.triangle_mult_bwd_epilogue_ref(s_r, xg, dy, ln_s, ln_b,
                                                   w_o, b_o, w_g, b_g)
        err4 = max(check_grad_close(a, b, f"K4 {name} {i}")
                   for i, (a, b) in enumerate(zip(epi, epi_r)))
        ds = epi_r[0]
        sides = ((ds, xa, xb, w_a, b_a, w_b, b_b),
                 (ds.transpose(0, 1), xb, xa, w_b, b_b, w_a, b_a))
        err5, ms5 = 0.0, []
        for side, args in enumerate(sides):
            got = kt.triangle_mult_bwd_dx(*args)
            want = ref.triangle_mult_bwd_dx_ref(*args)
            err5 = max([err5] + [check_grad_close(
                a, b, f"K5 {name} side {side} {i}")
                for i, (a, b) in enumerate(zip(got, want))])
            ms5.append(cuda_median(lambda args=args: kt.triangle_mult_bwd_dx(
                *args), 10))
            del got, want
        torch.cuda.synchronize()
        ms3 = cuda_median(lambda: kt.triangle_mult_fwd(xa, xb, xg, *w,
                                                       return_s=True), 10)
        ms4 = cuda_median(lambda: kt.triangle_mult_bwd_epilogue(
            s_k, xg, dy, ln_s, ln_b, w_o, b_o, w_g, b_g), 10)
        plain3 = cuda_time(lambda: ref.triangle_mult_ref(xa, xb, xg, *w,
                                                         return_s=True), 2)
        plain4 = cuda_time(lambda: ref.triangle_mult_bwd_epilogue_ref(
            s_k, xg, dy, ln_s, ln_b, w_o, b_o, w_g, b_g), 2)
        plain5 = [cuda_time(lambda args=args: ref.triangle_mult_bwd_dx_ref(
            *args), 2) for args in sides]
        P, Pb = ri * r, r * r
        wbytes = sum(t.numel() * el for t in w)
        f3 = (2.0 * (P + Pb) * c_z * 2 * c + 2.0 * P * r * c
              + 2.0 * P * c * c_z + 2.0 * P * c_z * c_z)
        by3 = (Pb + 2 * P) * c_z * el + wbytes + P * c * 4
        f4 = 6 * 2.0 * P * c * c_z
        by4 = P * c * 4 * 2 + 3 * P * c_z * el + (c * c_z + c_z * c_z) * (el + 4)
        # side 0: dx of the r/d xa rows, side 1: dx of all r xb rows
        f5 = [2.0 * P * r * c + 2 * 2.0 * n * c_z * 2 * c + 2 * 2.0 * m * c_z * 2 * c
              for n, m in ((P, Pb), (Pb, P))]
        by5 = [P * c * 4 + (n + m) * c_z * el + n * c_z * el
               + 2 * c_z * 2 * c * el + c_z * 2 * c * 4
               for n, m in ((P, Pb), (Pb, P))]
        for kernel, err, ms, plain, fl, by, n in (
                ("K3+s", err3, ms3, plain3, f3, by3, 2 * per),
                ("K4", err4, ms4, plain4, f4, by4, per),
                ("K5 side 0", err5, ms5[0], plain5[0], f5[0], by5[0], per),
                ("K5 side 1", err5, ms5[1], plain5[1], f5[1], by5[1], per)):
            b_ms, b_by = bound(fl, by)
            rows.append(dict(kernel=kernel, shape=name, r_i=ri, r=r, c_z=c_z,
                             c=c, per_cycle=n, max_abs_err=err,
                             **timed_fields("ms", ms), plain_ms=plain,
                             bound_ms=b_ms, bound_by=b_by))
        del x, w, xa, xb, xg, dy, y, s_k, y_r, s_r, epi, epi_r, ds, sides
        torch.cuda.empty_cache()
    return rows


def dap_totals(att_tots, tri_rows) -> dict:
    """Per-kernel ms of one DAP-2 rank's training sample-cycle (launches
    per cycle x median ms, summed over the shapes), beside the bound."""
    out = {"K1+lse": (att_tots["k1_lse"]["ms"], att_tots["k1_lse"]["bound_ms"]),
           "K2": (att_tots["k2"]["ms"], att_tots["k2"]["bound_ms"])}
    for row in tri_rows:
        name = row["kernel"].split()[0]
        ms, b = out.get(name, (0.0, 0.0))
        out[name] = (ms + row["per_cycle"] * row["ms"],
                     b + row["per_cycle"] * row["bound_ms"])
    return {k: {"ms": ms, "bound_ms": b} for k, (ms, b) in out.items()}


# plans of the parallel phase: name, ParallelPlan fields, ranks (of four).
# BP 2 on ranks 0-1 and DAP 2 on ranks 2-3 run at the same time on the card
# (each plan's walls include the other's load), then the hybrid on all four
PAR_PLANS = (("bp2", {"branch": 2}, (0, 1)),
             ("dap2", {"dap": 2}, (2, 3)),
             ("bp2_dap2", {"branch": 2, "dap": 2}, (0, 1, 2, 3)))
# (n_evoformer, n_extra_msa_blocks) of every plan, at af2_initial's widths:
# a plan shards each block alike, so more depth adds time and no path
PAR_DEPTH = (16, 4)
PAR_STEPS = 2
# plain SGD, no clip: the update is the learning rate times the gradient,
# so a gradient off by a factor (the group size, the data extent) moves
# the parameters by that factor.  The gradient norm at the seeded start is
# ~1.6e2 at 16 + 4 blocks (this phase's one-device run), so an update of
# ~0.08 in L2
PAR_LR = 5e-4
# a plan's step may differ from the one-device step by the order of its
# sums (partial gradients summed across ranks, shards' reductions): the
# losses within 2e-3 relative, and the gradient norms and the parameter
# update within 5e-2 of the one-device ones (bf16 compute)
PAR_LOSS_RTOL, PAR_UPDATE_RTOL = 2e-3, 5e-2


def par_cfg(cfg):
    return dataclasses.replace(cfg, n_evoformer=PAR_DEPTH[0],
                               n_extra_msa_blocks=PAR_DEPTH[1])


def par_runner(cfg, dev, plan=None, ranks=None):
    """The parallel phase's TrainRunner under ``plan`` over ``ranks`` (None:
    one device): the seeded model, batch 1, one cycle a step, plain SGD at
    PAR_LR with no clip (the update scales with the gradient), dropout on,
    no EMA, eager; its step walls are the spans of its SpanTracer."""
    from repro_torch.obs import SpanTracer
    from repro_torch.train.optim import sgd
    from repro_torch.train.trainer import TrainRunner
    return TrainRunner(cfg, plan, ranks=ranks, optimizer=sgd(PAR_LR),
                       batch_size=1, seed=TRAIN_SEED, recycle_sample=False,
                       n_recycle=1, ema_decay=None, deterministic=False,
                       device=dev, model=seeded_model(cfg, seed=0).to(dev),
                       graphs=False, tracer=SpanTracer())


def par_run(runner) -> list:
    """PAR_STEPS steps of ``runner``; returns each step's ``grad_norm``
    (the applied gradient's global norm)."""
    norms = []
    for s in range(PAR_STEPS):
        runner.run(s + 1)
        norms.append(runner.last_metrics["grad_norm"])
    return norms


def par_launches(cfg, role: str) -> dict:
    """One n_recycle-1 step's launches on a rank that runs ``role`` of each
    block: "all" (serial, DAP), "msa" (BP branch 0: row and column
    attention; the extra stack's column attention is global, no kernel) or
    "pair" (BP branch 1: triangle updates and attention)."""
    ne, nx = cfg.n_evoformer, cfg.n_extra_msa_blocks
    k1 = {"all": 4 * ne + 3 * nx, "msa": 2 * ne + nx, "pair": 2 * ne + 2 * nx}[role]
    k3 = 0 if role == "msa" else 2 * (ne + nx)
    return {"evo_attention_fwd": 2 * k1, "evo_attention_bwd": k1,
            "triangle_mult_fwd": 2 * k3, "triangle_mult_bwd_epilogue": k3,
            "triangle_mult_bwd_dx": 2 * k3, "flash_attention_fwd": 0}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def par_time_collectives(built, cfg, dev, n_params: int) -> dict:
    """Seconds (median of 3, host clock, card synchronized) of one
    collective of each kind over the plan's axes, at the main path's
    sizes: the pair shard's all-gather, the MSA shard's all-to-all, the
    gathered pair rep's reduce-scatter (DAP), the block exchange's and the
    gradient completion's all-reduce (BP)."""
    from repro_torch.parallel import collectives as coll
    ev, r, s = cfg.evoformer, cfg.n_res, cfg.n_seq
    out = {}

    def med(fn):
        ts = []
        for _ in range(3):
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[1]

    bf = dict(dtype=torch.bfloat16, device=dev)
    if "dap" in built.sync_axes:
        ax = built.axis("dap")
        d = ax.size
        z_l = torch.randn((r // d, r, ev.c_z), **bf)
        m_l = torch.randn((s // d, r, ev.c_m), **bf)
        z = torch.randn((r, r, ev.c_z), **bf)
        out["all_gather pair shard"] = (z_l.numel() * 2, med(
            lambda: coll.all_gather(z_l, ax, 0)))
        out["all_to_all msa shard"] = (m_l.numel() * 2, med(
            lambda: coll.all_to_all(m_l, ax, 1, 0)))
        out["reduce_scatter pair rep"] = (z.numel() * 2, med(
            lambda: coll._reduce_scatter_dim(z, ax, 0)))
    if "branch" in built.sync_axes:
        ax = built.axis("branch")
        ex = [torch.randn((s, r, ev.c_m), **bf), torch.randn((r, r, ev.c_z), **bf),
              torch.randn((r, r, ev.c_z), **bf)]
        out["psum block exchange"] = (sum(t.numel() for t in ex) * 2, med(
            lambda: coll.psum(tuple(ex), ax)))
        g = {"all": torch.randn((n_params,), device=dev)}
        out["psum gradient completion"] = (n_params * 4, med(
            lambda: coll.psum_tree(g, (ax,))))
    return out


def par_rank(rank, world, dev, cfg, serial_dir, plans):
    """One rank of the parallel phase at ``cfg`` (``par_cfg``'s depth):
    every plan of ``plans`` (its mesh
    built by all four ranks; a plan runs on its ranks while the others
    wait at the next mesh), PAR_STEPS steps with the launch counters and
    collective counts set to 0 just before and read just after; then the
    max |diff| of the parameters against the one-device run's (saved by
    the parent in ``serial_dir``) and the collectives' times."""
    from repro_torch.kernels import ops
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.plan import ParallelPlan
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = dev.type == "cuda"
    out = {}
    for name, kw, ranks_of in plans:
        if rank not in ranks_of:    # the plan's mesh: built by every rank
            ParallelPlan(**kw).build(list(ranks_of), cfg=cfg, device=dev)
            continue
        runner = par_runner(cfg, dev, ParallelPlan(**kw), list(ranks_of))
        built = runner.built
        init = {k: p.detach().clone() for k, p in runner.model.named_parameters()}
        _sync(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        coll.reset_counts()
        grad_norms = par_run(runner)
        _sync(dev)
        counts, colls = ops.launch_counts(), coll.counts()
        serial = torch.load(f"{serial_dir}/serial.pt", map_location=dev)
        d_max = max((p - serial[k]).abs().max().item()
                    for k, p in runner.model.named_parameters())
        num = sum((p.float() - serial[k].float()).square().sum()
                  for k, p in runner.model.named_parameters()).sqrt().item()
        den = sum((serial[k].float() - init[k].float()).square().sum()
                  for k in init).sqrt().item()
        coord = built.mesh.get_coordinate()
        role = "all"
        if "branch" in built.sync_axes:
            role = ("msa", "pair")[built.axis("branch").index]
        out[name] = {"rank": rank, "coord": coord, "role": role,
                     "losses": runner.history["loss"],
                     "grad_norms": grad_norms,
                     "step_s": step_walls(runner.tracer),
                     "launches": counts, "want": par_launches(cfg, role),
                     "collectives": colls, "max_param_diff": d_max,
                     "update_rel_diff": num / den,
                     "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                  if cuda else 0.0)}
        # every rank of the plan takes part in each timed collective
        out[name]["collective_s"] = par_time_collectives(
            built, cfg, dev, sum(t.numel() for t in init.values()))
        del runner, init, serial
        if cuda:
            torch.cuda.empty_cache()
    return out


def parallel_phase(cfg, dev):
    """Phase 9c at ``par_cfg(cfg)``.  The one-device run first, in this
    process (its parameters saved for the ranks), then four rank processes
    on this card over gloo (the backend of ranks sharing a card), each
    plan's steps held to the one-device steps' losses and parameters."""
    from repro_torch.parallel import ranks as ranks_lib
    pcfg = par_cfg(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        runner = par_runner(pcfg, dev)
        want_norms = par_run(runner)
        want_losses = runner.history["loss"]
        torch.save({k: p.detach().cpu()
                    for k, p in runner.model.named_parameters()},
                   f"{tmp}/serial.pt")
        print(f"[parallel serial] af2_initial {pcfg.n_evoformer}+"
              f"{pcfg.n_extra_msa_blocks} blocks, one device, losses "
              f"{want_losses}, gradient norms {want_norms}, step walls "
              f"{[round(x, 3) for x in step_walls(runner.tracer)]} s",
              flush=True)
        del runner
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        print(f"[parallel] {ranks_lib.describe_backend(dev.type, 'gloo', 4)}",
              flush=True)
        t0 = time.perf_counter()
        res = ranks_lib.spawn(par_rank, 4, pcfg, tmp, PAR_PLANS,
                              device_type=dev.type, backend="gloo",
                              timeout_s=900)
        wall = time.perf_counter() - t0
    print(f"[parallel] four rank processes on {dev.type} over gloo: "
          f"{wall:.1f} s with their start-up", flush=True)
    summary = {}
    for name, _, ranks_of in PAR_PLANS:
        rows = [res[r][name] for r in ranks_of]
        for row in rows:
            print(f"[parallel {name}] rank {row['rank']} mesh coordinate "
                  f"{row['coord']} ({row['role']} branch): losses "
                  f"{row['losses']} (one device {want_losses}), gradient "
                  f"norms {row['grad_norms']} (one device {want_norms}), "
                  f"step walls "
                  f"{[round(x, 3) for x in row['step_s']]} s, peak "
                  f"{row['peak_gib']:.2f} GiB, max |param diff| "
                  f"{row['max_param_diff']:.3g}, update rel L2 diff "
                  f"{row['update_rel_diff']:.3g}, launches {row['launches']}, "
                  f"collectives {row['collectives']}", flush=True)
            want_launch = {k: v * PAR_STEPS for k, v in row["want"].items()}
            if row["launches"] != want_launch:
                raise AssertionError(f"{name} rank {row['rank']}: launches "
                                     f"{row['launches']} != {want_launch}")
            for a, b in zip(row["losses"], want_losses):
                if not abs(a - b) <= PAR_LOSS_RTOL * abs(b):
                    raise AssertionError(f"{name}: loss {a} vs one device {b}")
            for a, b in zip(row["grad_norms"], want_norms):
                if not abs(a - b) <= PAR_UPDATE_RTOL * abs(b):
                    raise AssertionError(f"{name}: gradient norm {a} vs one "
                                         f"device {b}")
            if not row["update_rel_diff"] <= PAR_UPDATE_RTOL:
                raise AssertionError(f"{name}: update differs by "
                                     f"{row['update_rel_diff']} of its norm")

        print(f"[parallel collectives {name}] rank {rows[0]['rank']}, gloo"
              f"{', staged through host memory' if dev.type == 'cuda' else ''}"
              f", (bytes, median s): {json.dumps(rows[0]['collective_s'])}",
              flush=True)
        print(f"[parallel {name}] first loss bit for bit the one-device "
              f"loss: {rows[0]['losses'][0] == want_losses[0]}", flush=True)
        summary[name] = rows
    total = collections.Counter()
    for rows in summary.values():
        for row in rows:
            total.update(row["launches"])
    if any(total[k] == 0 for k in ("evo_attention_fwd", "evo_attention_bwd",
                                   "triangle_mult_fwd",
                                   "triangle_mult_bwd_epilogue",
                                   "triangle_mult_bwd_dx")):
        raise AssertionError(f"a kernel of the parallel path never ran: {total}")
    return summary, dict(total)


# ---------------------------------------------------------------------------
# Phase 9b: training data on the card, checkpoints and resume, remat="dots"
# ---------------------------------------------------------------------------

DATA_BATCHES = 6
RESUME_STEPS, RESUME_AT = 6, 3


def fasta_source(cfg):
    """8 deterministic demo FASTA records of 8..n_res residues."""
    from repro_torch.data.ingest import FastaSource, demo_fasta
    return FastaSource(demo_fasta(cfg, n_records=8, seed=TRAIN_SEED), cfg)


def check_pipeline_on_card(cfg, dev):
    """a. The record-path pipeline (length-bucketed, 2 workers) places its
    batches on the card; each is read on the consumer's stream as a
    captured step reads it (a copy into another buffer) while a matmul load
    keeps that stream busy and the next batch's copy is in flight.  The
    first DATA_BATCHES must equal the same pipeline's batches on the CPU
    (no workers) bit for bit.  Returns the card pipeline's StageReport."""
    from repro_torch.data.bucketing import train_bucket
    from repro_torch.data.pipeline import DataPipeline
    kw = dict(source=fasta_source(cfg), batch_size=1, seed=TRAIN_SEED,
              bucket_by_length=True, pad_to=train_bucket(cfg))
    want, got = [], []
    cpu = DataPipeline(cfg, workers=0, **kw)
    for step, batch in cpu:
        want.append((step, batch))
        if len(want) == DATA_BATCHES:
            break
    cpu.close()
    load = torch.randn((4096, 4096), device=dev, dtype=torch.bfloat16)
    card = DataPipeline(cfg, workers=2, device=dev, **kw)
    for step, batch in card:
        if not all(v.device.type == "cuda" for v in batch.values()):
            raise AssertionError(f"step {step}: a batch tensor is not on "
                                 "the card")
        got.append((step, {k: v.clone() for k, v in batch.items()}))
        for _ in range(50):
            load = load @ load * 1e-2
        if len(got) == DATA_BATCHES:
            break
    card.close()
    torch.cuda.synchronize()
    if [s for s, _ in got] != [s for s, _ in want]:
        raise AssertionError(f"steps {[s for s, _ in got]} != "
                             f"{[s for s, _ in want]}")
    for (step, g), (_, w) in zip(got, want):
        for k, v in w.items():
            if not torch.equal(g[k].cpu(), torch.from_numpy(v)):
                raise AssertionError(f"step {step}: {k} on the card differs "
                                     "from the CPU pipeline's")
    return card.report


def resume_runner(cfg, dev, ckpt_dir, model_seed: int):
    """A graphed TrainRunner on the FASTA records, one draw (n_recycle 1,
    one capture), checkpoints every RESUME_AT steps, the newest 2 kept,
    with a SpanTracer."""
    from repro_torch.obs import SpanTracer
    from repro_torch.train.trainer import TrainRunner
    return TrainRunner(cfg, batch_size=1, seed=TRAIN_SEED, device=dev,
                       tracer=SpanTracer(),
                       model=seeded_model(cfg, seed=model_seed).to(dev),
                       graphs=True, recycle_sample=False, n_recycle=1,
                       data_source=fasta_source(cfg), bucket_by_length=True,
                       data_workers=2, ckpt_dir=str(ckpt_dir),
                       ckpt_every=RESUME_AT, keep=2)


def train_state(runner) -> dict:
    """{(part, key): tensor} over the parameters, moments and EMA."""
    out = {}
    for part, tensors in (("params", dict(runner.model.named_parameters())),
                          ("mu", runner.state["opt"].mu),
                          ("nu", runner.state["opt"].nu),
                          ("ema", runner.state["ema"])):
        out.update({(part, k): t for k, t in tensors.items()})
    return out


def state_diff(losses_a, losses_b, state_a: dict, state_b: dict) -> dict:
    """Max |diff| of two runs' losses and of each part of their states."""
    out = {"loss": max(abs(x - y) for x, y in zip(losses_a, losses_b))}
    for (part, k), t in state_a.items():
        d = (t.float() - state_b[(part, k)].float()).abs().max().item()
        out[part] = max(out.get(part, 0.0), d)
    return out


def run_counted(runner, steps: int, n_steps: int, what: str) -> None:
    """``runner.run(steps)`` with the launch counters set to 0 just before;
    they must equal ``n_steps`` one-cycle training steps' launches."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    runner.run(steps)
    counts = ops.launch_counts()
    want = {k: n_steps * v for k, v in train_launches(runner.cfg, 1).items()}
    want["flash_attention_fwd"] = 0
    if counts != want:
        raise AssertionError(f"{what}: launches {counts} != the path's {want}")


def check_resume(cfg, dev, bound: float) -> dict:
    """b. Run A trains RESUME_STEPS steps (checkpoints at RESUME_AT and at
    the end); run B, a new runner from another model seed, restores step
    RESUME_AT and trains to RESUME_STEPS; run C is run A's runner restoring
    step RESUME_AT into the tensors its captured graph reads and replaying
    the steps after it.  B and C must equal A within ``bound``, restoring
    must capture nothing, and each run's launches must equal its steps'."""
    from repro_torch.train import checkpoint as ck
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        a = resume_runner(cfg, dev, d, model_seed=0)
        run_counted(a, RESUME_STEPS, RESUME_STEPS, "run A")
        if a.train_compiles != 1:
            raise AssertionError(f"run A captured {a.train_compiles} graphs")
        kept = sorted(p.name for p in pathlib.Path(d).iterdir())
        if kept != [f"step_{s:010d}" for s in (RESUME_AT, RESUME_STEPS)]:
            raise AssertionError(f"checkpoints kept: {kept}")
        final = {k: t.clone() for k, t in train_state(a).items()}
        a_losses = a.history["loss"][RESUME_AT:]
        out["bytes"] = ck.checkpoint_bytes(d, RESUME_AT)
        out["a_data"] = a.history["data"][-1]
        out["a_step_s"] = step_walls(a.tracer)

        b = resume_runner(cfg, dev, d, model_seed=1)
        if b.restore(step=RESUME_AT) != RESUME_AT or b.train_compiles != 0:
            raise AssertionError("run B: restore")
        run_counted(b, RESUME_STEPS, RESUME_STEPS - RESUME_AT, "run B")
        out["b"] = state_diff(a_losses, b.history["loss"], final,
                              train_state(b))
        out["b_step_s"] = step_walls(b.tracer)

        ptrs = {k: t.data_ptr() for k, t in train_state(a).items()}
        if a.restore(step=RESUME_AT) != RESUME_AT or a.train_compiles != 1:
            raise AssertionError(f"run C: restore captured "
                                 f"({a.train_compiles} graphs)")
        if {k: t.data_ptr() for k, t in train_state(a).items()} != ptrs:
            raise AssertionError("run C: restore rebound a tensor")
        run_counted(a, RESUME_STEPS, RESUME_STEPS - RESUME_AT, "run C")
        if a.train_compiles != 1:
            raise AssertionError(f"run C captured: train_compiles "
                                 f"{a.train_compiles}")
        out["c"] = state_diff(a_losses, a.history["loss"][RESUME_STEPS:],
                              final, train_state(a))
        out["c_step_s"] = step_walls(a.tracer)[RESUME_STEPS:]
        out["stats"] = {"A": a.mgr.stats, "B": b.mgr.stats}
        del a, b, final
    torch.cuda.empty_cache()
    for run in ("b", "c"):
        if any(v > bound for v in out[run].values()):
            raise AssertionError(f"run {run.upper()} strays from run A "
                                 f"beyond {bound}: {out[run]}")
    return out


def check_remat_dots(cfg, dev, bound: float) -> dict:
    """c. Two graphed one-cycle steps at remat="block", then the same two
    at remat="dots" from the same seeded model: losses, parameters,
    moments and EMA within ``bound``; peak allocated memory (the capture's
    eager run included) and step walls of each."""
    from repro_torch.obs import SpanTracer
    from repro_torch.train.trainer import TrainRunner
    runs = {}
    for remat in ("block", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        runner = TrainRunner(c, batch_size=1, seed=TRAIN_SEED, device=dev,
                             model=seeded_model(c, seed=0).to(dev),
                             graphs=True, recycle_sample=False, n_recycle=1,
                             tracer=SpanTracer())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run_counted(runner, 2, 2, f"remat={remat}")
        runs[remat] = {
            "losses": list(runner.history["loss"]),
            "state": {k: t.clone() for k, t in train_state(runner).items()},
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30,
            "step_s": step_walls(runner.tracer)}
        del runner
        torch.cuda.empty_cache()
    diff = state_diff(runs["block"]["losses"], runs["dots"]["losses"],
                      runs["block"]["state"], runs["dots"]["state"])
    if any(v > bound for v in diff.values()):
        raise AssertionError(f"remat=dots strays from remat=block beyond "
                             f"{bound}: {diff}")
    for r in runs.values():
        del r["state"]
    return {"diff": diff, **runs}


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


def lm_flop_shares(tag, cfg, engine) -> dict:
    """Model-FLOP shares of the H100's bf16 peak (``model_flops``, 2 x the
    active parameters a token) of the run's prefills, by prompt length
    (median prefill seconds), and of its decode steps (each step's tokens
    over its seconds; the median)."""
    from repro_torch.analysis.roofline import active_params, model_flops
    st = engine.last_stats
    secs = collections.defaultdict(list)
    for p in st["prefill"]:
        secs[p["prompt_len"]].append(p["seconds"])
    prefill = {}
    for n, ss in sorted(secs.items()):
        f, t = model_flops(cfg, "prefill", n, 1), float(np.median(ss))
        prefill[n] = {"model_flops": f, "median_s": round(t, 5),
                      "share": round(f / t / PEAK_BF16_FLOPS, 4)}
    dec = [model_flops(cfg, "decode", 1, k) / t / PEAK_BF16_FLOPS
           for k, t in zip(st["decode_tokens"], st["decode_step_s"])]
    row = {"active_params": active_params(cfg), "prefill": prefill,
           "decode_share_median": round(float(np.median(dec)), 5),
           "decode_share_range": [round(min(dec), 5), round(max(dec), 5)]}
    print(f"[lm model flops {tag}] {LM_ARCH}, 2 x {row['active_params']:.4g} "
          f"active parameters a token, shares of {PEAK_BF16_FLOPS:.4g} "
          f"FLOP/s: {json.dumps(row)}", flush=True)
    return row


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


# phase 12: static analysis
LINT_TIMEOUT_S = 300


def _src_env() -> dict:
    import os
    return {**os.environ, "PYTHONPATH": str(SRC)}


def _run(cmd, cwd, what: str) -> str:
    """Run a ``python -m`` command of the port in ``cwd``; its stdout, or
    AssertionError with its tail."""
    proc = subprocess.run([sys.executable, "-m", *cmd], cwd=cwd,
                          env=_src_env(), capture_output=True, text=True,
                          timeout=LINT_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def lint_matrix_on_card(tmp) -> dict:
    """12a: the lint CLI over the plan matrix, four gloo ranks on the card.
    Returns {program: {"peak", "findings", "overlap"}}."""
    report = pathlib.Path(tmp) / "report.json"
    out = _run(["repro_torch.analysis.lint", "--report", str(report)], tmp,
               "the lint CLI")
    if "lint: OK" not in out:
        raise AssertionError(f"lint CLI did not print 'lint: OK':\n{out}")
    data = json.loads(report.read_text())
    s = data["summary"]
    got = (s["n_programs"], s["n_pass_runs"], s["n_skipped"], s["n_unwaived"])
    if got != (8, 40, 0, 0):
        raise AssertionError(f"lint summary {s}")
    rows = {}
    for r in data["results"]:
        row = rows.setdefault(r["program"], {"findings": 0})
        row["findings"] += r["n_findings"]
        if r["pass"] == "materialization":
            row["peak"] = r["stats"]["peak_op_elems"]
        if r["pass"] == "retrace":
            row["overlap"] = r["stats"]["overlap"]
    for name, row in rows.items():
        print(f"[lint card] {name}: peak_op_elems {row['peak']}, findings "
              f"{row['findings']}, overlap {row['overlap']}", flush=True)
    return rows


def lint_fold_card_vs_cpu(dev) -> dict:
    """12b: fold:serial traced on the card and on the CPU: the same peak and
    finding codes, the same kernel nodes, K1 and K3 launched during the
    card's capture.  The launch counters are restored afterwards."""
    from repro_torch.analysis.static import all_passes, op_walk
    from repro_torch.analysis.static.program import capture_fold, lint_config
    from repro_torch.kernels import ops
    from repro_torch.parallel.plan import ParallelPlan
    saved = ops.launch_counts()
    cfg, out = lint_config(), {}
    try:
        for where in ("cpu", dev):
            ops.reset_launch_counts()
            prog = capture_fold("serial", ParallelPlan(), cfg, device=where)
            res = [p.run(prog) for p in all_passes()]
            out[torch.device(where).type] = {
                "peak": res[0].stats["peak_op_elems"],
                "codes": sorted(f.code for r in res for f in r.findings),
                "nodes": op_walk.count_ops(prog.traces["step"],
                                           ops.KERNELS),
                "launches": ops.launch_counts()}
    finally:
        ops.reset_launch_counts()
        ops.add_launch_counts(saved)
    cpu, card = out["cpu"], out["cuda"]
    if card["peak"] != cpu["peak"] or cpu["peak"]["step"] != 61440:
        raise AssertionError(f"peak_op_elems card {card['peak']} vs CPU "
                             f"{cpu['peak']} (the reference's 61440)")
    if card["codes"] != cpu["codes"] or card["nodes"] != cpu["nodes"]:
        raise AssertionError(f"card vs CPU: {card} vs {cpu}")
    if not (card["launches"]["evo_attention_fwd"] > 0
            and card["launches"]["triangle_mult_fwd"] > 0):
        raise AssertionError(f"K1 / K3 not launched during the card's "
                             f"capture: {card['launches']}")
    print(f"[lint fold] card vs CPU: peak_op_elems {card['peak']}, codes "
          f"{card['codes']}, kernel nodes {card['nodes']}; launches during "
          f"the card's capture {card['launches']}", flush=True)
    return out


def lint_launcher(tmp) -> dict:
    """12c: the train launcher at af2_initial (48 + 4 blocks) with --lint
    and --hlo-check: lint/ok 1, two steps, the overlap verdict skipped
    (one device)."""
    metrics = pathlib.Path(tmp) / "launch.jsonl"
    out = _run(["repro_torch.launch.train", "--af2", "initial", "--steps",
                "2", "--batch", "1", "--lint", "--hlo-check",
                "--metrics-out", str(metrics)], tmp, "the train launcher")
    rows = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    lint = {r["name"]: r["value"] for r in rows
            if r.get("name", "").startswith("lint/")}
    if lint.get("lint/ok") != 1 or lint.get("lint/unwaived") != 0:
        raise AssertionError(f"launch lint metrics {lint}")
    # one device has no async pair, so the verdict is skipped for that
    # reason alone; a trace that raised is recorded as skipped too, with
    # the exception as its reason and no pair count, and fails here
    verdicts = [r["value"] for r in rows
                if r.get("name") == "train/async_overlap_ok"]
    want = {"ok": None, "skipped": True, "pairs": 0,
            "reason": "no async collective start/wait pairs in the step"}
    if len(verdicts) != 1 or \
            any(verdicts[0].get(k, "missing") != v for k, v in want.items()):
        raise AssertionError(f"train/async_overlap_ok rows {verdicts}")
    overlap = [ln for ln in out.splitlines()
               if ln.startswith("async_overlap_ok:")]
    if "done: 2 steps" not in out or len(overlap) != 1:
        raise AssertionError(f"launcher output:\n{out[-3000:]}")
    for ln in out.splitlines():
        if ln.startswith(("lint:", "done:", "async_overlap_ok:")):
            print(f"[lint launch] {ln}", flush=True)
    return lint


def lint_phase(dev, card: str) -> None:
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lint_") as tmp:
        lint_matrix_on_card(tmp)
        t_a = time.perf_counter() - t0
        lint_fold_card_vs_cpu(dev)
        t_b = time.perf_counter() - t0 - t_a
        torch.cuda.empty_cache()
        lint_launcher(tmp)
    wall = time.perf_counter() - t0
    print(f"[lint phase] wall {wall:.1f} s (matrix {t_a:.1f} s, fold card vs "
          f"CPU {t_b:.1f} s, launcher {wall - t_a - t_b:.1f} s) on {card}",
          flush=True)


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

    t_start = time.perf_counter()

    def stamp(what):
        print(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

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

    stamp("phases 1-4")
    # phases 5 and 6, eager: the same engine without graphs
    reqs, engine = main_path(cfg, dev, graphs=False)
    eager = serve_folds(engine, reqs)
    sample_cycles = check_main_path(cfg, reqs, eager[0], engine, eager[1])
    fold_report("eager", cfg, eager[0], engine, *eager[1:], sample_cycles)
    profile_step(engine, reqs, eager[0], "fold")
    del engine
    torch.cuda.empty_cache()
    # phases 5 and 6, graphed: the first run captures each bucket's
    # sample-cycle, the second replays only; with a registry and a tracer
    from repro_torch.obs import MetricRegistry, SpanTracer
    reqs, engine = main_path(cfg, dev, graphs=True, obs=MetricRegistry(),
                             tracer=SpanTracer())
    serve_calls = count_calls(engine)
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
    check_serve_obs(engine, serve_calls, "phases 5-6")
    stamp("phases 5-6")
    # phase 5b: continuous serving on the same graphed engine (its recycle
    # steps replay the sample-cycle graphs phase 5 captured), then
    # long_plan routing over two gloo ranks
    continuous = continuous_phase(cfg, dev, engine, serve_per_cycle(cfg))
    check_serve_obs(engine, serve_calls, "phase 5b")
    del engine, eager, graphed
    torch.cuda.empty_cache()
    stamp("phase 5b")
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

    stamp("phases 7-8")
    # phase 9: eagerly twice (the second run is the yardstick of how far two
    # eager runs of the same steps agree), then graphed
    # the graphed runner keeps its telemetry in a registry with file sinks
    from repro_torch.obs import JsonlSink, MemorySink
    obs_dir = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    train_mem = MemorySink()
    train_obs = MetricRegistry(
        sinks=[train_mem, JsonlSink(f"{obs_dir}/metrics.jsonl")])
    runs = {}
    for tag, use in (("eager", False), ("eager again", False),
                     ("graphed", True)):
        runs[tag] = train_main_path(cfg, dev, graphs=use,
                                    obs=train_obs if use else None)
        train_report(tag, *runs[tag])
        if tag == "eager again":
            d_eager = train_diff(runs["eager"][0], runs.pop(tag)[0])
            torch.cuda.empty_cache()
    eager_runner, graphed_runner = runs["eager"][0], runs["graphed"][0]
    t_counts = runs["graphed"][1]
    if t_counts != runs["eager"][1]:
        raise AssertionError(f"graphed launches {t_counts} != eager "
                             f"{runs['eager'][1]}")
    d_graphed = train_diff(eager_runner, graphed_runner)
    print(f"[train path] max |diff| after the same {graphed_runner.step} "
          f"steps, graphed vs eager: {json.dumps(d_graphed)}; eager vs "
          f"eager: {json.dumps(d_eager)}", flush=True)
    if any(d_graphed[k] > d_eager[k] for k in d_eager):
        raise AssertionError("graphed training strays farther from eager "
                             "than a second eager run does")
    nrs = eager_runner.history["n_recycle"]
    e_s, g_s = (step_walls(r.tracer) for r in (eager_runner, graphed_runner))
    warm = TRAIN_WARMUP
    print(f"[train path] step walls by draw, (n_recycle, eager s, graphed s): "
          f"{[(n, round(a, 3), round(b, 3)) for n, a, b in zip(nrs[warm:], e_s[warm:], g_s[warm:])]}; "
          f"capture cost by draw, (n_recycle, graphed - eager warm-up s): "
          f"{[(n, round(b - a, 3)) for n, a, b in zip(nrs[:warm], e_s[:warm], g_s[:warm])]}",
          flush=True)
    for tag, runner in (("train", eager_runner),
                        ("train_graphed", graphed_runner)):
        # profile_run runs its work twice: two steps of the same draw
        nr = {runner.recycle_draw(runner.step + i) for i in (0, 1)}
        if len(nr) != 1:
            raise AssertionError(f"steps {runner.step} and {runner.step + 1} "
                                 f"draw n_recycle {nr}")
        profile_run(lambda runner=runner: runner.run(runner.step + 1), tag,
                    f"training steps {runner.step} (plain) and "
                    f"{runner.step + 1} (profiled), n_recycle {nr.pop()}")
    ev_eager, s_eager = evaluate_timed(eager_runner)
    check_evaluation(ev_eager, eager_runner)
    evs = [evaluate_timed(graphed_runner) for _ in range(2)]
    for ev, _ in evs:
        check_evaluation(ev, graphed_runner)
    if graphed_runner.eval_compiles != 1:
        raise AssertionError(f"eval_compiles {graphed_runner.eval_compiles}")
    if not np.array_equal(evs[0][0]["coords"], evs[1][0]["coords"]):
        raise AssertionError("two graphed evaluations of the same weights "
                             "differ")
    d_coords = np.abs(evs[1][0]["coords"] - ev_eager["coords"]).max()
    print(f"[train eval] lDDT-Cα of the EMA parameters on "
          f"{len(ev_eager['per_sample'])} held-out proteins, "
          f"{graphed_runner.eval_n_recycle} cycles: eager "
          f"{ev_eager['lddt_ca']:.4f} in {s_eager:.3f} s; graphed "
          f"{evs[0][0]['lddt_ca']:.4f} in {evs[0][1]:.3f} s (with its "
          f"capture), {evs[1][0]['lddt_ca']:.4f} in {evs[1][1]:.3f} s; "
          f"max |coords diff| graphed vs eager {d_coords:.6g} (their EMA "
          f"parameters' max |diff| {d_graphed['ema']:.3g}); train_compiles "
          f"{graphed_runner.train_compiles}, eval_compiles "
          f"{graphed_runner.eval_compiles}, compile_misses "
          f"{graphed_runner.compile_misses}", flush=True)
    try:
        obs_part(graphed_runner, train_mem, obs_dir, dev)
    finally:
        train_obs.close()
        shutil.rmtree(obs_dir, ignore_errors=True)
    del runs, eager_runner, graphed_runner, runner
    torch.cuda.empty_cache()

    stamp("phase 9")
    # phase 9b: the record-path pipeline on the card, checkpoints and resume
    # into the captured graphs, remat="dots"; held to phase 9's eager-vs-
    # eager distance
    bound = max(d_eager.values())
    rep = check_pipeline_on_card(cfg, dev)
    d = rep.as_dict()
    print(f"[train data] {DATA_BATCHES} record-path batches (8 FASTA "
          f"records, length-bucketed, 2 workers) placed on the card equal the "
          f"CPU pipeline's bit for bit; featurize "
          f"{d['featurize_ms_per_step']} ms/step, stall fraction "
          f"{d['stall_fraction']}, transfer {d['transfer_ms_per_step']} "
          f"ms/step, mean fill {d['mean_fill']}, buckets {d['buckets']}",
          flush=True)
    res = check_resume(cfg, dev, bound)
    st = res["stats"]
    print(f"[train resume] run A {RESUME_STEPS} graphed steps (n_recycle 1, "
          f"FASTA records), checkpoints at {RESUME_AT} and {RESUME_STEPS}: "
          f"{res['bytes']} bytes on disk each; snapshot s {st['A']['snapshot_s']}, "
          f"save s {st['A']['save_s']}; run B restored step {RESUME_AT} in "
          f"{st['B']['restore_s']} s; max |diff| vs run A: B {json.dumps(res['b'])}, "
          f"C (run A's runner, restored into its graph) {json.dumps(res['c'])}; "
          f"bound {bound}; train_compiles unchanged on restore; step walls A "
          f"{[round(x, 3) for x in res['a_step_s']]}, B "
          f"{[round(x, 3) for x in res['b_step_s']]}, C "
          f"{[round(x, 3) for x in res['c_step_s']]} s; run A's data "
          f"{json.dumps(res['a_data'])}", flush=True)
    rm = check_remat_dots(cfg, dev, bound)
    print(f"[train remat] 2 graphed steps, remat=dots vs remat=block: max "
          f"|diff| {json.dumps(rm['diff'])}; peak allocated (with the "
          f"capture's eager run) block {rm['block']['peak_gib']:.2f} GiB, "
          f"dots {rm['dots']['peak_gib']:.2f} GiB; reserved block "
          f"{rm['block']['reserved_gib']:.2f}, dots "
          f"{rm['dots']['reserved_gib']:.2f} GiB; step walls block "
          f"{[round(x, 3) for x in rm['block']['step_s']]}, dots "
          f"{[round(x, 3) for x in rm['dots']['step_s']]} s", flush=True)
    torch.cuda.empty_cache()

    stamp("phase 9b")
    # phase 9c: K1-K5 at a DAP-2 rank's shapes, then the training step under
    # BP, DAP and BP x DAP plans in four rank processes sharing the card
    dap_rows, dap_tots = check_attention_train(
        dev, dap_train_shapes(cfg), torch.bfloat16,
        ("dap2_msa_row", (cfg.n_seq // 2, cfg.n_res, cfg.evoformer.n_head_msa,
                          cfg.evoformer.c_hidden_att)))
    dap_tri = check_triangle_dap(
        dev, cfg.n_res, 2, cfg.evoformer.c_z, cfg.evoformer.c_hidden_mul,
        cfg.n_evoformer + cfg.n_extra_msa_blocks)
    for row in dap_rows + dap_tri:
        print(f"[parallel kernel] {json.dumps(row)}", flush=True)
    print(f"[parallel kernel total] one DAP-2 rank's sample-cycle of "
          f"training, ms: {json.dumps(dap_totals(dap_tots, dap_tri))}",
          flush=True)
    _, par_total = parallel_phase(cfg, dev)
    print(f"[parallel path] launches over every rank and plan: "
          f"{json.dumps(par_total)}", flush=True)
    torch.cuda.empty_cache()
    stamp("phase 9c")

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
        lm_flop_shares(tag, lm_cfg, lm_engine)
        served[tag] = lm_done, {rid: lm_rec.logits(rid) for rid in LM_CHECKED}
        lm_rec.restore()
        if not use:
            del lm_engine, lm_rec
            torch.cuda.empty_cache()
    (e_done, e_logits), (g_done, g_logits) = served["eager"], served["graphed"]
    differ = sum(a != b for r in e_done for a, b in zip(e_done[r], g_done[r]))
    d_logits = max((g_logits[r].float() - e_logits[r].float()).abs().max().item()
                   for r in LM_CHECKED)
    stamp("phases 10-11")
    print(f"[lm path] graphed vs eager: every token id agrees: {differ == 0} "
          f"({differ} of {sum(len(v) for v in e_done.values())} differ); max "
          f"|logits diff| of requests {list(LM_CHECKED)} {d_logits:.6g}",
          flush=True)
    profile_lm(lm_cfg, lm_engine)
    stamp("phase 11's profiles")
    del lm_engine, lm_weights
    torch.cuda.empty_cache()
    lint_phase(dev, card)
    stamp("phase 12")

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
        {**entry("evo_attention_fwd",
                 "src/repro_torch/csrc/evo_attention_fwd.cu",
                 "src/repro/kernels/flash_attention.py:181", k1_tot, k1_err,
                 counts["evo_attention_fwd"], serve_per),
         "continuous_launches": continuous["launches"]["evo_attention_fwd"]},
        {**entry("triangle_mult_fwd",
                 "src/repro_torch/csrc/triangle_mult_fwd.cu",
                 "src/repro/kernels/triangle.py:128", k3_tot, k3_err,
                 counts["triangle_mult_fwd"], serve_per),
         "continuous_launches": continuous["launches"]["triangle_mult_fwd"]},
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
