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
     8 + 2 blocks, eager, 2 recycles, injected costs: a one-device engine
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
  9. training main path: TrainRunner at af2_initial width (TRAIN_DEPTH =
     16 + 4 blocks, cut from 48 + 4 to keep the script inside its time;
     phase 13 (a) trains at 48 + 4; r 256 s 128 se 1024), batch 1, its
     defaults (AdamW, per-sample clipping, EMA, stochastic recycling
     1..4, dropout, remat="block", the synthetic stream through the
     DataPipeline with its device stage),
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
  9b. training data and checkpoints, af2_initial at full width and
     TRAIN_DEPTH, batch 1: (a) the record-path DataPipeline (8 demo FASTA
     records, length-bucketed, 2 workers) places 6 batches on the card,
     which must equal the same pipeline's batches on the CPU bit for bit;
     (b) graphed
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
 11b. the other LM families: K6 at head dim 112 against its plain version
     at zamba2-7b's prefill shapes (S 500 and 2048, 32 heads, causal) and
     on ragged / GQA / fp32 shapes; then qwen2-moe-a2.7b (24 layers, 60
     experts in 64 bank slots), mamba2-2.7b (64 layers) and zamba2-7b (81
     layers, a shared attention block at every 6th) at full width and
     depth, one at a time (weights freed before the next): phase 11's
     engine, checks and report over 4 requests (prompts 500, 2048, 500,
     2048) of 16 new tokens, eager then graphed, graphed equal to eager
     token for token and logit for logit, K6 launched 24 / 0 / 14 times a
     prefill; a MoE's plain paths take the served run's experts
     (LM_NOISE_FACTOR).  Then the serve launcher, ``--fold tiny
     --requests 3`` on one device and with ``--devices 2 --dap 2`` (two
     gloo ranks on the card): the same folds.
 11c. whisper-medium and internvl2-26b, and LM training: (a) K6 against
     its plain version at the whisper encoder's shape (4 x 1500 frames,
     non-causal, 16 heads of 64), whisper training's cross-attention (2 x
     448 queries over 1500 frames) and the internvl2 prefill (4 x 2048
     positions, causal, 48 heads over 8 KV heads of 128), with SDPA's time
     at the same is_causal / enable_gqa.  (b) whisper-medium (24 + 24
     layers, d 1024, vocab 51865) and (c) internvl2-26b (48 layers, d 6144,
     48 / 8 heads, vocab 92553) at full width and depth, seeded bf16
     weights drawn on the card, one at a time: 4 requests in one batch
     (whisper: seeded frames (1500, 1024) and a one-token BOS prompt, 32
     new tokens, cache 448; internvl2: seeded patches (256, 3200) and a
     1792-token prompt, 16 new tokens, cache 4096), a batched prefill then
     greedy decode steps, eagerly and then as CUDA graphs (graphed equal
     to eager, token for token and logit for logit); K6 launched 24 / 48
     times a prefill and never by a decode step; the logits of requests 1
     and 3 no farther from the fp32 plain path (chunked attention; fp32
     activations, bf16 weights upcast per op for internvl2) than 1.5x the
     plain bf16 path; time to first token, decode step ms, tokens/s,
     memory.  (d) whisper-medium training (batch 2 x 448 tokens over 1500
     frames, remat="layer", fp32 masters, AdamW 1e-4 with clip_norm 1):
     the first step's loss within 2e-3 and global gradient norm within
     5e-2 of the plain path's on the same weights and batch, everything
     finite, then 3 eager steps, K6 launched 144 times each (72 attention
     calls, each again in the remat recompute); step walls, peak memory.
     (e) ``launch.train --arch <a> --smoke --steps 3 --batch 2 --seq 32``
     for the six families on the card and with ``--device cpu``: every
     loss within 2e-2 relative, K6 launched once per attention call a
     step.
 11d. the AF2 default impls and LM data parallelism: (a) one af2_initial
     request (r 64 bucket) folded in fp32 at the config's own impls
     (chunked attention, chunked triangle updates, fused OPM) and at
     ``with_kernels``: max |coords diff| under phase 4's 1e-3; af2_tiny
     at those impls on the card against the CPU, phase 4's fp32 and bf16
     bounds; both walls.  (b) whisper-medium at full width and depth
     (fsdp=True) trained 3 steps at 2 x 448 tokens by the train
     launcher's ``run_lm`` on two gloo ranks sharing the card, as ``--arch
     whisper-medium --devices 2`` runs it: the first step's loss within
     2e-3 and gradient norm within 5e-2 of one device's on the same
     weights and batch, the gathered parameters after it within 5e-2
     (relative L2); each rank holds the parameter and moment bytes its
     specs predict (about half of one device's), K6 launched 144 times a
     step; peak memory, all-gathers / reduce-scatters / psums per step
     with their bytes, step walls (gloo staging: no measure of speed).
     (c) the six families at ``--smoke --devices 2`` against phase 11c
     (e)'s one-device runs: every loss within 3.2e-4 relative.  (d)
     ``bp_parallel_layer`` (a glm4-9b layer as a parallel block, S 512)
     on the two ranks against ``layer_apply``, within K6's bound.
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
 13. the dry run (``repro_torch.launch.dryrun``) against the card: (a)
     af2_initial's training step (48 + 4 blocks, batch 1, one recycle,
     remat block, K1-K5) and (b) whisper-medium's (2 x 448 tokens, remat
     layer, K6, AdamW) measured on the card and dry-run on ``meta``: each
     predicted peak within 10 % of the step's own (``max_memory_allocated``
     less what was allocated before it beyond its arguments), the
     predicted arguments, FLOPs and kernel nodes beside the card's; (c)
     each kernel's meta route against the kernel; (d) an af2_tiny cell on
     a 2x4 virtual mesh (the fake process group of this torch).  The
     kernel line's K2, K4 and K5 launches are (a)'s: one sample-cycle at
     48 + 4, as their times and bounds are priced.  (e) phase 14 (c)'s
     step traced for rank 0 of a (2, 2) virtual mesh: its predicted peak.
 14. tensor parallelism over 'model' (``parallel.tensor``) on four gloo
     ranks sharing the card, eager: K6 at (a)'s local shape against SDPA;
     (a) glm4-9b at full width and depth over (data 1, model 2) through
     ``DecodeEngine(mesh=...)``, phase 11's requests: K6 320 a rank (16
     query / 1 KV heads), bytes held a rank = the specs, tokens equal to
     phase 11's or parting only at a near tie (the row's max less its
     logit at one device's token within LM_NOISE_FACTOR x the plain bf16
     path's distance from fp32), first-token logits within that rule;
     (b) 2 layers over (1, 4) with ``factored_decode`` (KV split inside a
     head, decode on (kvh 2, brep 2)) against one device at that depth;
     (c) a 2-layer training step over (2, 2), fsdp, remat "layer", AdamW:
     the first loss within 2e-3 and gradient norm within 5e-2 of one
     device's, bytes held = the specs, the rank's peak within 10 % of
     phase 13 (e)'s; (d) qwen2-moe, mamba2, zamba2 (6 layers), whisper and
     internvl2 at 2 layers over (1, 2): one prefill and 3 decode steps fed
     one device's tokens, logits against the fp32 value within
     LM_NOISE_FACTOR x one device's bf16 distance, K6 a prefill.
Kernel and library times are medians of 5 timed repeats, each after a
warm-up call, printed with their min-max spread.  Then one JSON line of
kernel figures, the nvidia-smi line, and the result line ``{"ok": true,
"device": {...}}`` last.
"""
import collections
import contextlib
import copy
import dataclasses
import gc
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
    from repro_torch.kernels import cost as kcost
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
        flops, nbytes = kcost.evo_attention_fwd_cost(
            L, S, H, C, 2, bias_el=4 if masked else 0)
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
    from repro_torch.kernels import cost as kcost
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
        # x is the one activation input (xa, xb, xg all view it)
        flops, nbytes = kcost.triangle_mult_fwd_cost(
            r, r, r, c_z, c, 2, act_rows=r * r, masked=masked)
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
LONG_DEPTH = (8, 2)
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
    from repro_torch.kernels import cost as kcost
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
        f_flops, f_bytes = kcost.evo_attention_fwd_cost(
            L, S, H, C, el, bias_el=el if biased else 0, lse=True)
        b_flops, b_bytes = kcost.evo_attention_bwd_cost(
            L, S, H, C, el, bias_el=el if biased else 0)
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


# (n_evoformer, n_extra_msa_blocks) of phases 9 and 9b, at af2_initial's
# widths: cut from 48 + 4 to keep the whole script inside its time; their
# checks (graphed against eager, eager against eager, launches by draw, the
# evaluation, telemetry, resume into a captured graph) hold at any depth.
# Phase 13 (a) runs the training step at the full 48 + 4
TRAIN_DEPTH = (16, 4)


def train_cfg(cfg):
    return dataclasses.replace(cfg, n_evoformer=TRAIN_DEPTH[0],
                               n_extra_msa_blocks=TRAIN_DEPTH[1])


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
    cfg = runner.cfg
    print(f"[train path {tag}] af2_initial ({cfg.n_evoformer}+"
          f"{cfg.n_extra_msa_blocks} blocks) TrainRunner, batch "
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
    from repro_torch.kernels import cost as kcost
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
        # xa and xg view the shard's rows, xb is every row
        f3, by3 = kcost.triangle_mult_fwd_cost(ri, r, r, c_z, c, el,
                                               act_rows=Pb + P, s=True)
        f4, by4 = kcost.triangle_mult_bwd_epilogue_cost(P, c_z, c, el)
        # side 0: dx of the r/d xa rows, side 1: dx of all r xb rows
        (f5a, by5a), (f5b, by5b) = (
            kcost.triangle_mult_bwd_dx_cost(ri, r, r, c_z, c, el),
            kcost.triangle_mult_bwd_dx_cost(r, ri, r, c_z, c, el))
        f5, by5 = [f5a, f5b], [by5a, by5b]
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
PAR_DEPTH = (8, 2)
PAR_STEPS = 2
# plain SGD, no clip: the update is the learning rate times the gradient,
# so a gradient off by a factor f (the group size, the data extent) moves
# the update by |f - 1| of its norm, 0.5 or more for f = 2 or 1/2, ten
# times PAR_UPDATE_RTOL.  At 8 + 2 blocks the one-device gradient norms of
# the two steps are ~92 and ~25 on an H100, so the update, 5e-4 times the
# sum of the two gradients, is at most ~0.06 in L2 (each plan's line prints
# it), far above the ~1e-6 by which sums in another order move a parameter
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
                     "update_rel_diff": num / den, "update_l2": den,
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
                  f"{row['update_rel_diff']:.3g} (the one-device update's L2 "
                  f"{row['update_l2']:.4g}), launches {row['launches']}, "
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
    from repro_torch.kernels import cost as kcost
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
        flops, nbytes = kcost.flash_attention_fwd_cost(B, S, T, H, KV, D, el,
                                                       causal=causal)
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
# A MoE's top-k routing is discrete: one ulp of a bf16 router logit can
# move a token to another expert, and the served path (batch-1 prefill,
# 4-slot decode, K6) rounds other values than the plain path, so each moves
# some tokens' experts where the other does not, and a row behind a moved
# token lies several times farther from fp32 than the others: the max
# would compare which path drew more moves.  So for the moe family the plain
# paths (fp32 and bf16) take the experts the eager served run chose, token
# by token and layer by layer (``LogitRecorder.routes``), their gates from
# their own router logits; the token-layers where their own top-k differs
# are counted and printed.  A graphed run is held to the eager run's
# logits, which it must equal.


class LogitRecorder:
    """Wraps a DecodeEngine's steps ``_prefill1`` and ``_decode`` (eager
    functions, or CUDA-graph replays), so it sees every call, and keeps the
    logits they return to the engine for the requests ``rids``: each
    prefill's last row (in insert order, matched to a request through the
    engine's ``last_stats``) and their slot's row at each decode step
    (cloned: a graph's static output is overwritten by the next replay).

    Of an eager MoE engine it also keeps the experts each step chose (the
    ``idx`` of ``models.moe.router_topk``, one tensor a layer), so that
    ``routes(rid)`` gives a request's routing, token by token."""

    def __init__(self, engine, rids):
        self.engine, self.rids = engine, set(rids)
        self.clear()
        self._steps = engine._prefill1, engine._decode
        engine._prefill1, engine._decode = self._prefill, self._decode
        self._cur = None
        self._topk = None
        if engine.cfg.family == "moe" and not engine.graphs:
            from repro_torch.models import moe
            self._topk = moe.router_topk

            def recording(logits, k):
                out = self._topk(logits, k)
                if self._cur is not None:
                    self._cur.append(out[1].clone())
                return out
            moe.router_topk = recording

    def restore(self):
        """Give the engine back its own steps (and moe its router)."""
        self.engine._prefill1, self.engine._decode = self._steps
        if self._topk is not None:
            from repro_torch.models import moe
            moe.router_topk = self._topk

    def clear(self):
        self.prefills, self.steps = [], collections.defaultdict(list)
        self.prefill_routes, self.step_routes = [], collections.defaultdict(
            list)

    def _prefill(self, prompt):
        self._cur = []
        logits = self._steps[0](prompt)
        self.prefills.append(logits[0, -1].clone())
        self.prefill_routes.append(self._cur)
        self._cur = None
        return logits

    def _decode(self, tokens):
        self._cur = []
        logits = self._steps[1](tokens)
        for i, req in enumerate(self.engine.slots):
            if req is not None and req.rid in self.rids:
                self.steps[req.rid].append(logits[i, 0].clone())
                if self._cur:
                    self.step_routes[req.rid].append([r[i] for r in self._cur])
        self._cur = None
        return logits

    def _order(self, rid) -> int:
        return [p["rid"] for p in self.engine.last_stats["prefill"]].index(rid)

    def logits(self, rid):
        """(new tokens, V): the rows the engine took each token of ``rid``
        from."""
        return torch.stack([self.prefills[self._order(rid)],
                            *self.steps[rid]])

    def routes(self, rid):
        """Per layer, the experts (prompt + decode steps, k) ``rid``'s tokens
        were routed to, or None where none were recorded."""
        pre = self.prefill_routes[self._order(rid)]
        if not pre:
            return None
        steps = self.step_routes[rid]
        return [torch.cat([pre[l], *(st[l][None] for st in steps)])
                for l in range(len(pre))]


def lm_params(dev, arch=LM_ARCH):
    """``arch``'s config and seeded bf16 weights drawn on the card, one
    module at a time; returns (cfg, params, seconds to draw them)."""
    from repro_torch import configs
    from repro_torch.models import get_model
    from repro_torch.models.lmconfig import with_kernels
    cfg = with_kernels(configs.get_config(arch))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = get_model(cfg).init_params(cfg, seed=0, device=dev,
                                        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


def lm_main_path(cfg, params, dev, *, graphs: bool, prompts=LM_PROMPTS,
                 new_tokens=LM_NEW_TOKENS, checked=LM_CHECKED):
    """``cfg``'s family (glm4-9b in phase 11) through a DecodeEngine
    (``graphs`` on or off) that serves through a LogitRecorder of the
    requests ``checked``: warm-up requests (one of 64 tokens; with graphs
    also one of each prompt length, so that every step is captured before
    the measured run), then one request per prompt length of ``prompts``
    (``new_tokens`` each) with the launch counters set to 0 just before and
    read just after.  Returns (engine, recorder, requests, results, launch
    counts, wall seconds, peak allocated GiB, reserved GiB, warm-up
    seconds)."""
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.serve.engine import DecodeEngine, Request
    engine = DecodeEngine(get_model(cfg), cfg, params, batch_slots=LM_SLOTS,
                          max_len=LM_MAX_LEN, device=dev, graphs=graphs)
    rec = LogitRecorder(engine, checked)
    rng = np.random.default_rng(0)
    prompt = lambda n: rng.integers(0, cfg.vocab, n, dtype=np.int32)
    warm = [Request(rid=-1, prompt=prompt(64), max_new_tokens=2)]
    reqs = [Request(rid=i, prompt=prompt(n), max_new_tokens=new_tokens)
            for i, n in enumerate(prompts)]
    if graphs:
        warm += [Request(rid=-2 - i, prompt=prompt(n), max_new_tokens=2)
                 for i, n in enumerate(sorted(set(prompts)))]
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


def pinned_router(routes, moved: list):
    """A stand-in for ``models.moe.router_topk`` that returns, layer by
    layer, the experts of ``routes`` (one (S, k) tensor a layer) with gates
    renormalised from its own router probabilities; ``moved`` counts
    [token-layers where its own top-k chose other experts, token-layers]."""
    from repro_torch.models import moe
    layers, own = iter(routes), moe.router_topk

    def topk(logits, k):
        idx = next(layers).to(logits.device)
        _, idx_own, probs = own(logits, k)
        moved[0] += int((idx_own.sort(-1).values != idx.sort(-1).values)
                        .any(-1).sum())
        moved[1] += idx.shape[0]
        gates = probs.gather(-1, idx)
        return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), \
            idx, probs
    return topk


def plain_lm_logits(params, cfg, tokens, start: int, dtype, routes=None,
                    moved=None):
    """Logits (S - start, V), fp32, at positions start.. of ``tokens``
    (1, S) on the plain path: ``forward``'s body (the family's
    ``backbone``) with chunked attention and no cache, the SSM families'
    chunked SSD over the whole sequence, activations in ``dtype`` (bf16 as
    ``forward``; fp32 gives the value of the same bf16 weights).  A MoE's
    experts come from ``routes`` (``pinned_router``) when given."""
    from repro_torch.models import dense, get_model, moe
    cfg = dataclasses.replace(cfg, attention_impl="chunked")
    own = moe.router_topk
    if routes is not None:
        moe.router_topk = pinned_router(routes, moved)
    try:
        with torch.no_grad():
            x = params.embed.table[tokens.long()].to(dtype)
            pos = torch.arange(tokens.shape[1], dtype=torch.int32,
                               device=tokens.device)[None]
            x = get_model(cfg).backbone(params, cfg, x, pos)
            return dense.logits_fn(params, cfg, x[:, start:])[0].float()
    finally:
        moe.router_topk = own


def check_lm_main_path(cfg, engine, rec, reqs, done, counts, refs, *,
                       new_tokens=LM_NEW_TOKENS, checked=LM_CHECKED,
                       k6_per_prefill=None) -> list:
    """Every request's ``new_tokens`` token ids in the vocabulary; K6
    launched ``k6_per_prefill`` times per prompt (default: once per layer)
    and nothing else.  For each request of ``checked``, the engine's logits
    for all its tokens (the prefill's last row, then its slot's row of each
    batched decode step, read from the slot-copied cache) against the plain
    path on prompt + tokens[:-1]: no farther from the fp32 value than
    LM_NOISE_FACTOR times the plain bf16 path, and each token the argmax of
    its row.  ``refs`` keeps the plain path's values by request and tokens,
    for a second run that served the same tokens.  Returns per checked
    request (rid, max |served - fp32|, max |plain bf16 - fp32|)."""
    if sorted(done) != [r.rid for r in reqs]:
        raise AssertionError(f"served {sorted(done)}")
    for r in reqs:
        toks = np.asarray(done[r.rid])
        if toks.shape != (new_tokens,) or toks.min() < 0 or \
                toks.max() >= cfg.vocab:
            raise AssertionError(f"request {r.rid}: tokens {toks}")
    want = {k: 0 for k in counts}
    want["flash_attention_fwd"] = (cfg.n_layer if k6_per_prefill is None
                                   else k6_per_prefill) * len(reqs)
    if counts != want:
        raise AssertionError(f"{cfg.arch_id} launches {counts} != the "
                             f"path's {want}")
    out = []
    for rid in checked:
        prompt, gen = reqs[rid].prompt, done[rid]
        served = rec.logits(rid).float()
        if served.shape != (new_tokens, cfg.vocab) or not torch.equal(
                served.argmax(-1).cpu(), torch.as_tensor(gen)):
            raise AssertionError(f"request {rid}: recorded logits "
                                 f"{tuple(served.shape)} do not give its "
                                 f"tokens")
        key = (rid, tuple(gen))
        if key not in refs:
            tokens = torch.as_tensor(np.concatenate([prompt, gen[:-1]]),
                                     device=engine.device)[None]
            start = len(prompt) - 1
            routes = rec.routes(rid) if cfg.family == "moe" else None
            if cfg.family == "moe" and routes is None:
                raise AssertionError(f"{cfg.arch_id}: no routing recorded "
                                     f"(an eager run comes first)")
            moved = {"fp32": [0, 0], "bf16": [0, 0]}
            ref32 = plain_lm_logits(engine.params, cfg, tokens, start,
                                    torch.float32, routes, moved["fp32"])
            noise = (plain_lm_logits(engine.params, cfg, tokens, start,
                                     torch.bfloat16, routes, moved["bf16"])
                     - ref32).abs().max().item()
            refs[key] = ref32, noise, moved
        ref32, noise, moved = refs[key]
        err = (served - ref32).abs().max().item()
        pinned = (f"; on the served routing, own top-k elsewhere in "
                  f"fp32 {moved['fp32'][0]} and bf16 {moved['bf16'][0]} of "
                  f"{moved['fp32'][1]} token-layers"
                  if cfg.family == "moe" else "")
        print(f"[lm check] {cfg.arch_id} request {rid} (prompt "
              f"{len(prompt)}): max |served - fp32| {err:.4g}, plain bf16 "
              f"{noise:.4g}, |fp32| max {ref32.abs().max().item():.4g}"
              f"{pinned}", flush=True)
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
    print(f"[lm path {tag}] {cfg.arch_id} ({cfg.n_layer} layers, d "
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
    print(f"[lm model flops {tag}] {cfg.arch_id}, 2 x "
          f"{row['active_params']:.4g} "
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


# ---------------------------------------------------------------------------
# Phase 11b: the moe, ssm and hybrid families at full width and depth
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("qwen2-moe-a2.7b", "mamba2-2.7b", "zamba2-7b")
# 500 tokens pad the SSD's 256-token chunk; requests 1 and 3 (2048 tokens,
# in slots 1 and 3 beside live slots) are held to the plain path
FAMILY_PROMPTS = (500, 2048, 500, 2048)
FAMILY_NEW_TOKENS = 16
FAMILY_CHECKED = (1, 3)
# K6's launches a prefill: every MoE layer's attention, none in mamba2, one
# a invocation of zamba2's shared block (81 layers, every 6th)
FAMILY_K6 = {"qwen2-moe-a2.7b": 24, "mamba2-2.7b": 0, "zamba2-7b": 14}


def d112_kernel_shapes(cfg):
    """K6 rows at zamba2-7b's shared attention (H = KV = 32, D 112): each
    prefill length of phase 11b with its launches there (one a shared-block
    invocation a prompt), then D-112 checks the path does not reach."""
    H, KV, D = cfg.n_head, cfg.n_kv_head, cfg.d_head
    bf, f32 = torch.bfloat16, torch.float32
    per_len = collections.Counter(FAMILY_PROMPTS)
    rows = [(f"zamba2_prefill_S{n}", (1, n, n, H, KV, D), True, bf,
             FAMILY_K6[cfg.arch_id] * per_len[n]) for n in sorted(per_len)]
    rows += [("d112_gqa_ragged_S77_noncausal", (2, 77, 77, 4, 2, D), False,
              bf, 0),
             ("d112_causal_S130_T70", (1, 130, 70, 4, 4, D), True, bf, 0),
             ("d112_fp32_S300", (1, 300, 300, 4, 4, D), True, f32, 0)]
    return rows


def family_phase(arch: str, dev) -> dict:
    """``arch`` at full width and depth through the LM path: seeded bf16
    weights drawn on the card, a DecodeEngine of LM_SLOTS slots and cache
    LM_MAX_LEN serving FAMILY_PROMPTS (FAMILY_NEW_TOKENS each) eagerly and
    then graphed (warm-up captures first), each run held to the plain path
    and its K6 launches to the family's; graphed must equal eager, token
    for token and logit for logit.  Frees the engine and the weights."""
    cfg, params, init_s = lm_params(dev, arch)
    n_params = sum(p.numel() for p in params.parameters())
    kw = dict(new_tokens=FAMILY_NEW_TOKENS, checked=FAMILY_CHECKED)
    refs, served, row = {}, {}, {"params": n_params, "init_s": init_s}
    for tag, use in (("eager", False), ("graphed", True)):
        engine, rec, reqs, done, counts, wall, peak, reserved, warm_s = \
            lm_main_path(cfg, params, dev, graphs=use,
                         prompts=FAMILY_PROMPTS, **kw)
        errs = check_lm_main_path(cfg, engine, rec, reqs, done, counts, refs,
                                  k6_per_prefill=FAMILY_K6[arch], **kw)
        if engine.compile_misses != 1 + len(set(FAMILY_PROMPTS) | {64}):
            raise AssertionError(f"{arch}: compile_misses "
                                 f"{engine.compile_misses}")
        lm_report(tag, cfg, engine, done, wall, peak, reserved, warm_s,
                  init_s, n_params, errs)
        print(f"[lm path {tag}] {arch} launches {counts}", flush=True)
        flops = lm_flop_shares(tag, cfg, engine)
        st = engine.last_stats
        dec_tok, dec_s = sum(st["decode_tokens"]), sum(st["decode_step_s"])
        ttft = collections.defaultdict(list)
        for pre in st["prefill"]:
            ttft[pre["prompt_len"]].append(round(pre["seconds"], 4))
        row[tag] = {"wall_s": wall, "warm_s": warm_s, "peak_gib": peak,
                    "reserved_gib": reserved, "prefill_s": dict(ttft),
                    "decode_tokens_per_s": dec_tok / dec_s,
                    "decode_step_median_ms": 1e3 * float(
                        np.median(st["decode_step_s"])),
                    "k6_launches": counts["flash_attention_fwd"],
                    "logits_vs_fp32": errs,
                    "prefill_share_of_peak": {
                        n: r["share"] for n, r in flops["prefill"].items()}}
        served[tag] = done, {rid: rec.logits(rid) for rid in FAMILY_CHECKED}
        rec.restore()
        del engine, rec
        torch.cuda.empty_cache()
    (e_done, e_logits), (g_done, g_logits) = served["eager"], served["graphed"]
    differ = sum(a != b for r in e_done for a, b in zip(e_done[r], g_done[r]))
    d_logits = max((g_logits[r].float() - e_logits[r].float()).abs().max()
                   .item() for r in FAMILY_CHECKED)
    row["graphed_vs_eager"] = {"tokens_differ": differ,
                               "max_logits_diff": d_logits}
    print(f"[lm family] {arch}: graphed vs eager {differ} of "
          f"{sum(len(v) for v in e_done.values())} tokens differ, max "
          f"|logits diff| of requests {list(FAMILY_CHECKED)} {d_logits:.6g}; "
          f"{json.dumps(row)}", flush=True)
    if differ or d_logits != 0.0:
        raise AssertionError(f"{arch}: graphed serving differs from eager")
    del params
    torch.cuda.empty_cache()
    return row


def fold_launcher_phase() -> dict:
    """The serve launcher's fold path on the card, af2_tiny, 3 requests: on
    one device (graphed), then ``--devices 2 --dap 2`` (two rank processes
    on this card over gloo, eager, the longest bucket under dap=2); rank
    0's folds must equal the one device's: recycles and buckets exactly,
    pLDDT and contact probabilities within LONG_RTOL relative L2,
    coordinates within 1e-3."""
    from repro_torch.launch import serve
    base = ["--fold", "tiny", "--requests", "3"]
    t0 = time.perf_counter()
    one = serve.main(base)
    t1 = time.perf_counter()
    two = serve.main(base + ["--devices", "2", "--dap", "2"])
    t2 = time.perf_counter()
    if sorted(one) != sorted(two) or sorted(one) != [0, 1, 2]:
        raise AssertionError(f"launcher folds {sorted(one)} vs {sorted(two)}")
    d_max, rel = 0.0, 0.0
    for rid in one:
        a, b = two[rid], one[rid]
        if a.n_recycles != b.n_recycles or a.bucket != b.bucket:
            raise AssertionError(f"request {rid}: ranks {a.n_recycles} "
                                 f"recycles in {a.bucket}, one device "
                                 f"{b.n_recycles} in {b.bucket}")
        if not np.abs(a.coords - b.coords).max() <= 1e-3:
            raise AssertionError(f"request {rid}: coordinates differ")
        for x, y in ((a.plddt, b.plddt), (a.contact_probs, b.contact_probs),
                     (a.coords, b.coords)):
            d_max = max(d_max, float(np.abs(x - y).max()))
        for x, y in ((a.plddt, b.plddt), (a.contact_probs, b.contact_probs)):
            rel = max(rel, float(np.linalg.norm(x - y) / np.linalg.norm(y)))
    if not rel <= LONG_RTOL:
        raise AssertionError(f"launcher ranks' folds differ from one "
                             f"device's by {rel} relative L2")
    row = {"one_device_s": t1 - t0, "two_ranks_s": t2 - t1,
           "max_abs_diff": d_max, "max_rel_l2": rel,
           "bit_equal": d_max == 0.0}
    print(f"[serve launcher] --fold tiny --requests 3: one device vs "
          f"--devices 2 --dap 2 (two gloo ranks on the card): "
          f"{json.dumps(row)}", flush=True)
    return row


# ---------------------------------------------------------------------------
# Phase 11c: whisper-medium and internvl2-26b serving, LM training
# ---------------------------------------------------------------------------

WHISPER_ARCH, VLM_ARCH = "whisper-medium", "internvl2-26b"
AV_REQUESTS = 4
# requests whose logits are held to the plain path (slots 1 and 3)
AV_CHECKED = (1, 3)
WHISPER_BOS = 50258            # <|startoftranscript|>
WHISPER_NEW_TOKENS = 32
WHISPER_MAX_LEN = 448          # whisper's text context
VLM_PROMPT = 1792              # + 256 patches: 2048 positions
VLM_NEW_TOKENS = 16
VLM_MAX_LEN = 4096
TRAIN_LM_BATCH, TRAIN_LM_SEQ, TRAIN_LM_STEPS = 2, 448, 3
TRAIN_LM_LR = 1e-4
# phase 9c's bounds on a kernel path's first step against the plain path
TRAIN_LM_LOSS_RTOL, TRAIN_LM_GNORM_RTOL = 2e-3, 5e-2
# the train launcher's losses on the card against the same command on the
# CPU (bf16 rounding apart)
LAUNCH_RTOL = 2e-2
LAUNCH_ARCHS = ("glm4-9b", "qwen2-moe-a2.7b", "mamba2-2.7b", "zamba2-7b",
                "whisper-medium", "internvl2-26b")
LAUNCH_ARGS = ("--smoke", "--steps", "3", "--batch", "2", "--seq", "32")


def attention_calls(cfg) -> int:
    """Attention calls of one forward of ``cfg`` over a sequence: one a
    layer (whisper: its encoder's, then its decoder's causal and cross
    attention), one a shared-block invocation of the hybrid, none in
    mamba2."""
    from repro_torch.models import hybrid
    if cfg.family == "audio":
        return cfg.n_enc_layer + 2 * cfg.n_layer
    if cfg.family == "hybrid":
        return hybrid.n_shared_invocations(cfg)
    return 0 if cfg.family == "ssm" else cfg.n_layer


def whisper_train_k6(cfg) -> int:
    """K6 launches of one whisper training step: every attention's forward
    (``attention_calls``), and each again when ``remat="layer"`` recomputes
    its layer for the backward; the backward itself is the plain chunked
    VJP, which launches nothing."""
    return attention_calls(cfg) * (2 if cfg.remat == "layer" else 1)


def av_kernel_shapes(wcfg, vcfg):
    """K6 rows at phase 11c's shapes: the whisper encoder (non-causal, S = T
    = 1500 frames, D 64), whisper training's cross-attention (S 448 over T
    1500 frames) and the internvl2 prefill (causal, 48 heads over 8 KV
    heads, D 128, 2048 positions), with their launches: a prefill's, a
    training step's and a prefill's."""
    bf = torch.bfloat16
    n_frames = wcfg.n_frontend_tokens
    w = (wcfg.n_head, wcfg.n_kv_head, wcfg.d_head)
    npos = vcfg.n_frontend_tokens + VLM_PROMPT
    return [
        (f"whisper_encoder_S{n_frames}", (AV_REQUESTS, n_frames, n_frames, *w),
         False, bf, wcfg.n_enc_layer),
        (f"whisper_cross_S{TRAIN_LM_SEQ}_T{n_frames}",
         (TRAIN_LM_BATCH, TRAIN_LM_SEQ, n_frames, *w), False, bf,
         2 * wcfg.n_layer),
        (f"internvl2_prefill_S{npos}",
         (AV_REQUESTS, npos, npos, vcfg.n_head, vcfg.n_kv_head, vcfg.d_head),
         True, bf, vcfg.n_layer)]


def seeded_bf16(shape, seed: int, dev):
    """N(0, 1) drawn in fp32 on ``dev`` from a generator seeded ``seed``,
    as bf16."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


@contextlib.contextmanager
def compute_dtype(module, dtype):
    """``module``'s cast policy (its global ``BF16``) computing in
    ``dtype``."""
    from repro_torch.nn.layers import Policy
    saved = module.BF16
    module.BF16 = Policy(compute_dtype=dtype)
    try:
        yield
    finally:
        module.BF16 = saved


def av_serve(cfg, params, dev, inputs: dict, new_tokens: int, max_len: int,
             *, graphs: bool) -> dict:
    """``cfg``'s family (whisper or the VLM) serving AV_REQUESTS requests in
    one batch: a batched ``prefill`` of ``inputs`` (frames or patches and
    the prompts), then greedy ``decode_step``s to ``new_tokens`` tokens
    each, on one cache of ``max_len`` positions written in place.  With
    ``graphs`` the prefill and the decode step are ``graphs.CapturedStep``s,
    captured by a warm-up pass first.  The launch counters are set to 0
    just before the measured pass; returns its tokens (B, new_tokens),
    every step's logits (new_tokens, B, V) fp32, the K6 launches after the
    prefill and at the end, the cache's bytes, the prefill's and each
    decode step's seconds, the wall and peak / reserved GiB."""
    from repro_torch import graphs as graphs_lib
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    model = get_model(cfg)
    keys = list(inputs)
    cache = model.init_cache(cfg, AV_REQUESTS, max_len, device=dev)

    def prefill_fn(*tensors):
        for t in cache.values():
            t.zero_()
        logits, new = model.prefill(params, cfg, dict(zip(keys, tensors)),
                                    cache)
        cache["length"].copy_(new["length"])
        return logits

    def decode_fn(tokens):
        logits, new = model.decode_step(params, cfg, tokens, cache)
        cache["length"].copy_(new["length"])
        return logits

    prefill, decode = prefill_fn, decode_fn
    if graphs:
        pool = torch.cuda.graph_pool_handle()
        prefill = graphs_lib.CapturedStep(prefill_fn, pool=pool)
        decode = graphs_lib.CapturedStep(decode_fn, pool=pool)

    def run():
        t0 = time.perf_counter()
        logits = prefill(*inputs.values())
        tok = logits[:, -1].argmax(-1, keepdim=True)
        rows = [logits[:, -1].float().clone()]
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        k6_prefill = ops.launch_counts()["flash_attention_fwd"]
        toks, steps = [tok], []
        for _ in range(new_tokens - 1):
            t1 = time.perf_counter()
            logits = decode(tok)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            rows.append(logits[:, -1].float().clone())
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t1)
            toks.append(tok)
        return (torch.cat(toks, 1).cpu(), torch.stack(rows), k6_prefill,
                pre_s, steps, time.perf_counter() - t0)

    with torch.no_grad():
        warm_s = 0.0
        if graphs:
            t0 = time.perf_counter()
            run()                 # captures the prefill and the decode step
            warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        tokens, logits, k6_prefill, pre_s, steps, wall = run()
    return {"tokens": tokens, "logits": logits, "k6_prefill": k6_prefill,
            "cache_bytes": sum(t.numel() * t.element_size()
                               for t in cache.values()),
            "counts": ops.launch_counts(), "prefill_s": pre_s,
            "decode_s": steps, "wall_s": wall, "warm_s": warm_s,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30}


def plain_whisper_logits(params, cfg, frames, tokens, dtype):
    """(S, V) fp32: whisper's ``forward`` on the plain path (chunked
    attention) on one request's frames (1, T, F) and tokens (1, S), its
    casts at ``dtype`` (fp32: the value of the bf16 weights; whisper-medium
    is small enough for an fp32 copy)."""
    from repro_torch.models import whisper
    cfg = dataclasses.replace(cfg, attention_impl="chunked")
    with torch.no_grad(), compute_dtype(whisper, dtype):
        out = whisper.forward(params, cfg, {"frames": frames,
                                            "tokens": tokens})
    return out[0].float()


def plain_vlm_logits(params, cfg, patches, tokens, start: int, dtype):
    """(P + S - start, V) fp32: the VLM's ``forward`` body on the plain path
    (chunked attention) over one request's patches (1, P, F) and tokens (1,
    S), from position ``start`` of the P + S, activations in ``dtype`` and
    each op upcasting its bf16 weights (no fp32 copy of the 26B model)."""
    from repro_torch.models import dense, vlm
    cfg = dataclasses.replace(cfg, attention_impl="chunked")
    with torch.no_grad():
        img = vlm.project_patches(params, patches.to(dtype))
        txt = params.embed.table[tokens.long()].to(dtype)
        x = torch.cat([img, txt], dim=1)
        pos = torch.arange(x.shape[1], dtype=torch.int32,
                           device=x.device)[None]
        x = dense.backbone(params, cfg, x, pos)
        return dense.logits_fn(params, cfg, x[:, start:])[0].float()


def check_av_run(cfg, run: dict, plain, refs: dict, k6_per_prefill: int,
                 new_tokens: int) -> list:
    """A run of ``av_serve``: tokens in the vocabulary, K6 launched
    ``k6_per_prefill`` times by the prefill and never by a decode step, no
    other kernel; for each request of AV_CHECKED its served logits no
    farther from ``plain(rid, tokens, fp32)`` than LM_NOISE_FACTOR times the
    plain bf16 path (``refs`` keeps them by request and tokens).  Returns
    [(rid, max |served - fp32|, max |plain bf16 - fp32|)]."""
    toks = run["tokens"]
    if toks.shape != (AV_REQUESTS, new_tokens) or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab:
        raise AssertionError(f"{cfg.arch_id}: tokens {toks}")
    want = {k: 0 for k in run["counts"]}
    want["flash_attention_fwd"] = k6_per_prefill
    if run["k6_prefill"] != k6_per_prefill or run["counts"] != want:
        raise AssertionError(f"{cfg.arch_id}: K6 {run['k6_prefill']} a "
                             f"prefill, launches {run['counts']} != {want}")
    out = []
    for rid in AV_CHECKED:
        served = run["logits"][:, rid]
        if not torch.equal(served.argmax(-1).cpu(), toks[rid]):
            raise AssertionError(f"request {rid}: logits do not give its "
                                 f"tokens")
        key = (rid, tuple(toks[rid].tolist()))
        if key not in refs:
            ref32 = plain(rid, toks[rid], torch.float32)
            noise = (plain(rid, toks[rid], torch.bfloat16) - ref32
                     ).abs().max().item()
            refs[key] = ref32, noise
        ref32, noise = refs[key]
        err = (served - ref32).abs().max().item()
        print(f"[av check] {cfg.arch_id} request {rid}: max |served - fp32| "
              f"{err:.4g}, plain bf16 {noise:.4g}, |fp32| max "
              f"{ref32.abs().max().item():.4g}", flush=True)
        if not err <= LM_NOISE_FACTOR * noise:
            raise AssertionError(f"{cfg.arch_id} request {rid}: served "
                                 f"logits {err} from the fp32 plain path, "
                                 f"over {LM_NOISE_FACTOR} x {noise}")
        out.append((rid, err, noise))
    return out


def av_family_phase(arch: str, dev) -> dict:
    """``arch`` (whisper-medium or internvl2-26b) at full width and depth:
    seeded bf16 weights drawn on the card; AV_REQUESTS requests served by
    ``av_serve`` eagerly and then graphed, each run held to
    ``check_av_run``; graphed must equal eager, token for token and logit
    for logit.  Frees the weights."""
    cfg, params, init_s = lm_params(dev, arch)
    n_params = sum(p.numel() for p in params.parameters())
    if cfg.family == "audio":
        frames = seeded_bf16((AV_REQUESTS, cfg.n_frontend_tokens,
                              cfg.frontend_dim), 21, dev)
        prompt = torch.full((AV_REQUESTS, 1), WHISPER_BOS, dtype=torch.int64,
                            device=dev)
        inputs = {"frames": frames, "tokens": prompt}
        new, max_len, k6 = WHISPER_NEW_TOKENS, WHISPER_MAX_LEN, cfg.n_enc_layer

        def plain(rid, toks, dtype):
            tokens = torch.cat([prompt[rid], toks[:-1].to(dev)])[None]
            return plain_whisper_logits(params, cfg, frames[rid:rid + 1],
                                        tokens, dtype)
    else:
        patches = seeded_bf16((AV_REQUESTS, cfg.n_frontend_tokens,
                               cfg.frontend_dim), 22, dev)
        rng = np.random.default_rng(22)
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (AV_REQUESTS,
                                                             VLM_PROMPT)),
                                 dtype=torch.int64, device=dev)
        inputs = {"patches": patches, "tokens": prompt}
        new, max_len, k6 = VLM_NEW_TOKENS, VLM_MAX_LEN, cfg.n_layer
        start = cfg.n_frontend_tokens + VLM_PROMPT - 1

        def plain(rid, toks, dtype):
            tokens = torch.cat([prompt[rid], toks[:-1].to(dev)])[None]
            return plain_vlm_logits(params, cfg, patches[rid:rid + 1],
                                    tokens, start, dtype)
    refs, runs, row = {}, {}, {"params": n_params, "init_s": init_s}
    for tag, use in (("eager", False), ("graphed", True)):
        run = av_serve(cfg, params, dev, inputs, new, max_len, graphs=use)
        errs = check_av_run(cfg, run, plain, refs, k6, new)
        dec = sorted(run["decode_s"])
        total = AV_REQUESTS * new
        # a decode step reads every weight and the whole cache at least once
        read = sum(p.numel() * p.element_size() for p in params.parameters())
        row[tag] = {
            "k6_launches_a_prefill": run["k6_prefill"],
            "time_to_first_token_s": run["prefill_s"],
            "decode_step_median_ms": 1e3 * dec[len(dec) // 2],
            "decode_step_ms_range": [1e3 * dec[0], 1e3 * dec[-1]],
            "decode_step_bound_ms": 1e3 * (read + run["cache_bytes"])
            / PEAK_BYTES,
            "tokens_per_s": total / run["wall_s"], "wall_s": run["wall_s"],
            "warm_s": run["warm_s"], "peak_gib": run["peak_gib"],
            "reserved_gib": run["reserved_gib"], "logits_vs_fp32": errs}
        print(f"[av path {tag}] {arch} ({cfg.n_layer} layers"
              + (f" + {cfg.n_enc_layer} encoder" if cfg.n_enc_layer else "")
              + f", d {cfg.d_model}, {n_params / 1e9:.3f} B parameters, bf16 "
              f"weights drawn in {init_s:.1f}s): {AV_REQUESTS} requests x "
              f"{new} tokens, cache {max_len}: {json.dumps(row[tag])}",
              flush=True)
        runs[tag] = run
    e, g = runs["eager"], runs["graphed"]
    differ = int((e["tokens"] != g["tokens"]).sum())
    d_logits = (e["logits"] - g["logits"]).abs().max().item()
    row["graphed_vs_eager"] = {"tokens_differ": differ,
                               "max_logits_diff": d_logits}
    print(f"[av family] {arch}: graphed vs eager {differ} of "
          f"{AV_REQUESTS * new} tokens differ, max |logits diff| "
          f"{d_logits:.6g}", flush=True)
    if differ or d_logits != 0.0:
        raise AssertionError(f"{arch}: graphed serving differs from eager")
    del params, runs, e, g, refs
    torch.cuda.empty_cache()
    return row


def whisper_train_phase(dev) -> dict:
    """whisper-medium training at full width and depth on one fixed batch
    (TRAIN_LM_BATCH x TRAIN_LM_SEQ tokens of ``token_batch``, seeded frames),
    ``remat="layer"``, fp32 masters drawn on the card: the first step's
    loss and global gradient norm on the kernel path against the plain path
    (chunked attention) on the same weights, then TRAIN_LM_STEPS eager
    steps of ``make_lm_train_step`` (AdamW at a constant TRAIN_LM_LR,
    clip_norm 1.0), K6 launched ``whisper_train_k6`` times each."""
    from repro_torch import configs
    from repro_torch.data.tokens import token_batch
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.models.lmconfig import with_kernels
    from repro_torch.train.optim import adamw, global_norm
    from repro_torch.train.trainstep import (init_lm_state,
                                             lm_value_and_grad,
                                             make_lm_train_step)
    cfg = dataclasses.replace(with_kernels(configs.get_config(WHISPER_ARCH)),
                              remat="layer")
    lm = get_model(cfg)
    want_k6 = whisper_train_k6(cfg)
    print(f"[lm train] {WHISPER_ARCH}: K6 predicted {want_k6} launches a "
          f"step ({attention_calls(cfg)} attention calls forward, each again "
          f"in the remat recompute)", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = lm.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    b = token_batch(0, 0, TRAIN_LM_BATCH, TRAIN_LM_SEQ, cfg.vocab)
    batch = {"tokens": torch.as_tensor(b["tokens"], device=dev),
             "labels": torch.as_tensor(b["labels"], device=dev),
             "frames": seeded_bf16((TRAIN_LM_BATCH, cfg.n_frontend_tokens,
                                    cfg.frontend_dim), 23, dev)}

    def first(c):
        ops.reset_launch_counts()
        loss, grads = lm_value_and_grad(lm, c, model, batch)
        counts = ops.launch_counts()
        finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
        return loss.item(), global_norm(grads).item(), finite, counts

    loss_k, norm_k, fin_k, counts = first(cfg)
    loss_p, norm_p, fin_p, _ = first(dataclasses.replace(
        cfg, attention_impl="chunked"))
    want = {k: 0 for k in counts}
    want["flash_attention_fwd"] = want_k6
    row = {"params": sum(p.numel() for p in model.parameters()),
           "init_s": init_s, "loss": [loss_k, loss_p],
           "grad_norm": [norm_k, norm_p], "first_step_launches": counts}
    print(f"[lm train] {WHISPER_ARCH} first step, kernel vs plain path: "
          f"loss {loss_k:.6f} / {loss_p:.6f}, global grad norm "
          f"{norm_k:.6f} / {norm_p:.6f}; launches {counts}", flush=True)
    if not (fin_k and fin_p and np.isfinite([loss_k, loss_p, norm_k,
                                             norm_p]).all()):
        raise AssertionError(f"{WHISPER_ARCH}: non-finite loss or gradient")
    if abs(loss_k - loss_p) > TRAIN_LM_LOSS_RTOL * abs(loss_p) or \
            abs(norm_k - norm_p) > TRAIN_LM_GNORM_RTOL * abs(norm_p):
        raise AssertionError(f"{WHISPER_ARCH}: the kernel path's first step "
                             f"left the plain path's bounds")
    if counts != want:
        raise AssertionError(f"{WHISPER_ARCH}: launches {counts} != {want}")
    opt = adamw(TRAIN_LM_LR, clip_norm=1.0)
    step = make_lm_train_step(lm, cfg, opt)
    state = init_lm_state(model, opt)
    losses, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_LM_STEPS):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = metrics["loss"].item()
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        if ops.launch_counts() != want or not np.isfinite(loss):
            raise AssertionError(f"{WHISPER_ARCH} step: loss {loss}, "
                                 f"launches {ops.launch_counts()}")
    if not all(bool(torch.isfinite(p).all()) for p in model.parameters()):
        raise AssertionError(f"{WHISPER_ARCH}: non-finite parameters")
    row.update(losses=losses, step_s=walls, k6_launches_a_step=want_k6,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               reserved_gib=torch.cuda.memory_reserved() / 2 ** 30)
    print(f"[lm train] {WHISPER_ARCH} ({cfg.n_enc_layer} + {cfg.n_layer} "
          f"layers, remat=layer, batch "
          f"{TRAIN_LM_BATCH} x {TRAIN_LM_SEQ} tokens over "
          f"{cfg.n_frontend_tokens} frames, AdamW {TRAIN_LM_LR}): "
          f"{json.dumps(row)}", flush=True)
    del model, state, step, opt, batch
    torch.cuda.empty_cache()
    return row


def lm_launcher_phase() -> dict:
    """``launch.train --arch <a> LAUNCH_ARGS`` for each of LAUNCH_ARCHS, in
    this process: on the card (K6 launched once per attention call a step)
    and with ``--device cpu``; each step's loss within LAUNCH_RTOL relative
    of the CPU's (the weights come from a CPU generator and the batches
    from ``token_batch``, so both see the same inputs)."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    rows = {}
    for arch in LAUNCH_ARCHS:
        argv = ["--arch", arch, *LAUNCH_ARGS]
        steps = int(LAUNCH_ARGS[LAUNCH_ARGS.index("--steps") + 1])
        want_k6 = steps * attention_calls(configs.get_smoke_config(arch))
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        card = train.main(argv)
        card_s = time.perf_counter() - t0
        k6 = ops.launch_counts()["flash_attention_fwd"]
        cpu = train.main(argv + ["--device", "cpu"])
        rel = max(abs(card[s] - cpu[s]) / abs(cpu[s]) for s in cpu)
        rows[arch] = {"card": card, "cpu": cpu, "max_rel": rel,
                      "k6_launches": k6, "card_s": card_s}
        print(f"[lm launcher] {arch}: {json.dumps(rows[arch])}", flush=True)
        if sorted(card) != list(range(steps)) or sorted(cpu) != sorted(card):
            raise AssertionError(f"{arch}: steps {sorted(card)} / "
                                 f"{sorted(cpu)}")
        if not rel <= LAUNCH_RTOL:
            raise AssertionError(f"{arch}: card losses {card} vs CPU {cpu}")
        if k6 != want_k6:
            raise AssertionError(f"{arch}: K6 launched {k6} times, the "
                                 f"path's {want_k6}")
    return rows


def av_phase(dev) -> dict:
    """Phase 11c: (a) K6 at the new shapes, (b) whisper-medium and (c)
    internvl2-26b serving, (d) whisper-medium training, (e) the train
    launcher for every family."""
    from repro_torch import configs
    t0 = time.perf_counter()
    rows, tot = check_flash_attention(dev, av_kernel_shapes(
        configs.get_config(WHISPER_ARCH), configs.get_config(VLM_ARCH)))
    for row in rows:
        print(f"[av kernel] flash_attention_fwd {json.dumps(row)}", flush=True)
    out = {"k6_rows": rows}
    for arch in (WHISPER_ARCH, VLM_ARCH):
        out[arch] = av_family_phase(arch, dev)
    out["train"] = whisper_train_phase(dev)
    out["launcher"] = lm_launcher_phase()
    out["wall_s"] = time.perf_counter() - t0
    print(f"[av phase] wall {out['wall_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 11d: the AF2 default impls on the card; LM data-parallel FSDP
# training over two gloo ranks sharing the card; bp_parallel_layer
# ---------------------------------------------------------------------------

FSDP_ARCH = "whisper-medium"
FSDP_RANKS = 2
# the launcher's run at phase 11c (d)'s batch: 2 x 448 tokens, 3 steps
FSDP_ARGS = ("--arch", FSDP_ARCH, "--steps", "3", "--batch",
             str(TRAIN_LM_BATCH), "--seq", str(TRAIN_LM_SEQ))
# phase 11c (d)'s peak on one device at the same batch (an earlier run of
# this script on an H100 80GB HBM3 at 700 W)
ONE_DEVICE_PEAK_GIB = 15.99
# the gathered parameters after step 1 against one device's: relative L2
# over every leaf
FSDP_PARAM_RTOL = 5e-2
# the launcher's six families at --smoke, two ranks against one device:
# every loss of the three steps within the 3.2e-4 relative that phase
# 11c (e) has shown between the card and the CPU (each rank rounds its half
# of a bf16 weight gradient before the sum, as two GEMM libraries round
# differently; the first step's loss, on the same weights, agrees within
# 1e-7)
DP_RTOL = 3.2e-4
DEFAULTS_BUCKET_FRAC = 0.25     # af2_initial's r 256 -> the r-64 bucket


def af2_defaults_phase(dev) -> dict:
    """11d (a): one af2_initial request folded at the r-64 bucket at the
    config's own impls (chunked attention, chunked triangle updates, fused
    OPM) and at ``with_kernels``, fp32, on the card: max |coords diff|
    within phase 4's fp32 bound (1e-3); then af2_tiny at the defaults on
    the card against the CPU, fp32 (1e-3) and bf16 (3x the CPU's own bf16
    distance), as phase 4 holds the kernels.  Prints each fold's wall."""
    from repro_torch.core import model as af2
    from repro_torch.core.config import af2_initial, af2_tiny, with_kernels
    from repro_torch.data.synthetic import make_fold_requests
    from repro_torch.serve import fold_steps as fs
    cfg = af2_initial()
    (req,) = make_fold_requests(cfg, 1, seed=11,
                                fracs=(DEFAULTS_BUCKET_FRAC,))
    f = req.features
    bucket = fs.Bucket(64, f["msa_feat"].shape[0],
                       f["extra_msa_feat"].shape[0])
    batch = fs.stack_padded([fs.pad_to_bucket(f, bucket)], 1)
    model = seeded_model(cfg, seed=0).to(dev)
    out, walls = {}, {}
    for tag, c in (("defaults", cfg), ("kernels", with_kernels(cfg))):
        for _ in range(2):          # the second call is the timed one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = af2.predict(model, c, batch, max_recycle=1, tol=0.0,
                              dtype=torch.float32)
            torch.cuda.synchronize()
            walls[tag] = time.perf_counter() - t0
        out[tag] = res["coords"].float().cpu()
    d_init = (out["defaults"] - out["kernels"]).abs().max().item()
    ev = cfg.evoformer
    print(f"[af2 defaults] af2_initial ({cfg.n_evoformer} + "
          f"{cfg.n_extra_msa_blocks} blocks) r {f['msa_feat'].shape[1]} in "
          f"bucket {bucket}, fp32, one cycle: impls {ev.attention_impl} / "
          f"{ev.tri_mult_impl} / {ev.opm_impl} {walls['defaults']:.3f} s, "
          f"with_kernels {walls['kernels']:.3f} s; max |coords diff| "
          f"{d_init:.3g}", flush=True)
    if not (d_init < 1e-3 and out["defaults"].abs().max().item() > 0.1
            and torch.isfinite(out["defaults"]).all()):
        raise AssertionError(f"af2_initial at the defaults vs with_kernels: "
                             f"max |coords diff| {d_init}")
    del model
    torch.cuda.empty_cache()
    tiny = af2_tiny()
    cpu_model = seeded_model(with_kernels(tiny), seed=3, noise=0.1)
    card_model = copy.deepcopy(cpu_model).to(dev)
    reqs = make_fold_requests(tiny, 2, seed=3, fracs=(1.0, 0.7))
    tb = fs.Bucket(tiny.n_res, tiny.n_seq, tiny.n_extra_seq)
    tbatch = fs.stack_padded([fs.pad_to_bucket(r.features, tb)
                              for r in reqs], 2)

    def coords(m, dtype):
        return af2.predict(m, tiny, tbatch, max_recycle=2, tol=0.0,
                           dtype=dtype)["coords"].float().cpu()

    cpu32 = coords(cpu_model, torch.float32)
    err32 = (coords(card_model, torch.float32) - cpu32).abs().max().item()
    err16 = (coords(card_model, torch.bfloat16) - cpu32).abs().max().item()
    noise16 = (coords(cpu_model, torch.bfloat16) - cpu32).abs().max().item()
    print(f"[af2 defaults] af2_tiny at the defaults, card vs CPU: fp32 max "
          f"|coords diff| {err32:.3g}; bf16 card {err16:.3g} from the CPU's "
          f"fp32 fold (CPU bf16 {noise16:.3g}, bound 3x)", flush=True)
    if not (err32 < 1e-3 and err16 <= 3 * noise16):
        raise AssertionError(f"af2_tiny at the defaults: card vs CPU fp32 "
                             f"{err32}, bf16 {err16} (CPU bf16 {noise16})")
    return {"initial_walls": walls, "initial_diff": d_init,
            "tiny": [err32, err16, noise16]}


def _one_device_first_step(args, dev) -> dict:
    """One step of the launcher's recipe on one device (``args``): the
    weights the launcher draws, its first batch and optimizer; returns the
    loss, the gradient norm, the parameters before and after (on the
    host, so that they do not count in the ranks' peaks)."""
    from repro_torch import configs
    from repro_torch.data.tokens import token_batch
    from repro_torch.models import get_model
    from repro_torch.models.lmconfig import with_kernels
    from repro_torch.train.optim import adamw, warmup_cosine
    from repro_torch.train.trainstep import init_lm_state, make_lm_train_step
    cfg = with_kernels(configs.get_config(args.arch))
    lm = get_model(cfg)
    opt = adamw(warmup_cosine(args.lr, 20, args.steps), clip_norm=1.0)
    model = lm.init_params(cfg, seed=0, device=dev)
    p0 = {k: p.detach().to("cpu", copy=True)
          for k, p in model.named_parameters()}
    b = token_batch(0, 0, args.batch, args.seq, cfg.vocab)
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.as_tensor(b["tokens"], device=dev),
             "labels": torch.as_tensor(b["labels"], device=dev),
             "frames": torch.randn(
                 (args.batch, cfg.n_frontend_tokens, cfg.frontend_dim),
                 generator=g).to(torch.bfloat16).to(dev)}
    state = init_lm_state(model, opt)
    _, m = make_lm_train_step(lm, cfg, opt)(state, batch)
    out = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
           "p0": p0, "p1": {k: p.detach().to("cpu", copy=True)
                            for k, p in model.named_parameters()}}
    del state, model
    return out


def fsdp_rank(rank, world, dev, inp) -> dict:
    """Phase 11d (b)-(d) on one of two gloo ranks sharing the card: the
    launcher's ``run_lm`` at ``FSDP_ARGS`` (rank 0 first runs the
    one-device step of the same recipe and holds the gathered step-1
    parameters to it), then the six families at ``--smoke``, then
    ``bp_parallel_layer``."""
    import dataclasses as dc
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import dense
    from repro_torch.models.lmconfig import with_kernels
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.mesh_utils import Axis, make_mesh
    from repro_torch.train.trainstep import param_dict
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = train.parse_args(list(FSDP_ARGS))
    ref = _one_device_first_step(args, dev) if rank == 0 else None
    torch.cuda.empty_cache()
    row = {"step_s": [], "grad_norm": [], "collectives": [],
           "k6_launches": []}
    marks = {}

    def mark():
        torch.cuda.synchronize()
        marks["counts"], marks["bytes"] = coll.counts(), coll.byte_counts()
        ops.reset_launch_counts()

    def on_step(step, state, metrics):
        counts, nbytes = coll.counts(), coll.byte_counts()
        row["collectives"].append({
            k: [counts[k] - marks["counts"][k], nbytes[k] - marks["bytes"][k]]
            for k in ("all_gather", "reduce_scatter", "psum")})
        row["step_s"].append(metrics["step_s"])
        row["grad_norm"].append(metrics["grad_norm"].item())
        row["k6_launches"].append(ops.launch_counts()["flash_attention_fwd"])
        layout = state["layout"]
        if step == 0:
            opt = state["opt"]
            held = {"params": layout.bytes_held(param_dict(state["params"])),
                    "mu": layout.bytes_held(opt.mu),
                    "nu": layout.bytes_held(opt.nu)}
            full = sum(4 * int(np.prod(s)) for s in layout.shapes.values())
            rep = sum(4 * int(np.prod(layout.shapes[k]))
                      for k, d in layout.dims.items() if d is None)
            row["held"] = held
            row["one_device_bytes"] = 3 * full
            row["expected_bytes"] = 3 * (rep + (full - rep) // world)
            row["leaves"] = [len(layout.sharded), len(layout.dims)]
            sq = {"diff": 0.0, "ref": 0.0, "move": 0.0}
            for k, p in param_dict(state["params"]).items():
                full_p = layout.full(k, p.detach()).cpu()
                if ref is not None:
                    sq["diff"] += (full_p - ref["p1"][k]).float().square(
                        ).sum().item()
                    sq["ref"] += ref["p1"][k].float().square().sum().item()
                    sq["move"] += (ref["p1"][k] - ref["p0"][k]).float(
                        ).square().sum().item()
                del full_p
            if ref is not None:
                row["first"] = {
                    "loss": [metrics["loss"].item(), ref["loss"]],
                    "grad_norm": [metrics["grad_norm"].item(),
                                  ref["grad_norm"]],
                    "params_rel": (sq["diff"] / sq["ref"]) ** 0.5,
                    "params_rel_to_move": (sq["diff"] / sq["move"]) ** 0.5}
        mark()

    mark()
    t0 = time.perf_counter()
    row["losses"] = train.run_lm(args, rank=rank, world=world, device=dev,
                                 on_step=on_step)
    row["wall_s"] = time.perf_counter() - t0
    row["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del ref
    torch.cuda.empty_cache()
    out = {FSDP_ARCH: row, "families": {}}
    t0 = time.perf_counter()
    for arch in LAUNCH_ARCHS:
        fargs = train.parse_args(["--arch", arch, *LAUNCH_ARGS])
        out["families"][arch] = train.run_lm(fargs, rank=rank, world=world,
                                             device=dev)
    out["families_s"] = time.perf_counter() - t0
    # (d): one glm4-9b layer at full width as a parallel block
    cfg = dc.replace(with_kernels(configs.get_config(LM_ARCH)),
                     parallel_block=True)
    gen = torch.Generator(device=dev).manual_seed(5)
    layer = dense.Layer(cfg, generator=gen, device=dev).to(torch.bfloat16)
    x = seeded_bf16((1, 512, cfg.d_model), 6, dev)
    pos = torch.arange(512, dtype=torch.int32, device=dev)[None]
    axis = Axis(make_mesh((world,), ("branch",)), "branch")
    with torch.no_grad():
        ops.reset_launch_counts()
        got, _ = dense.bp_parallel_layer(layer, cfg, x, pos, axis=axis)
        bp_k6 = ops.launch_counts()["flash_attention_fwd"]
        want, _ = dense.layer_apply(layer, cfg, x, pos)
    out["bp"] = {"max_abs_diff": (got.float() - want.float()).abs().max()
                 .item(), "scale": want.float().abs().max().item(),
                 "k6_launches": bp_k6}
    return out


def fsdp_phase(dev, card: str, one_device: dict) -> dict:
    """Phase 11d (b)-(d) over FSDP_RANKS gloo ranks sharing the card, held
    to the one-device runs: rank 0's first step and gathered parameters
    (b), ``one_device`` {arch: {step: loss}} of the six families' launcher
    runs on the card (c), ``layer_apply`` (d)."""
    from repro_torch import configs
    from repro_torch.parallel import ranks as ranks_lib
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = ranks_lib.spawn(fsdp_rank, FSDP_RANKS, None, device_type=dev.type,
                          backend="gloo", timeout_s=900)
    spawn_s = time.perf_counter() - t0
    for rank, res in enumerate(got):
        row = res[FSDP_ARCH]
        held = sum(sum(v.values()) for v in row["held"].values())
        print(f"[fsdp] {FSDP_ARCH} rank {rank} of {FSDP_RANKS} ({card}): "
              f"{row['leaves'][0]} of {row['leaves'][1]} leaves sharded; "
              f"holds {held / 2 ** 30:.3f} GiB of parameters + mu + nu "
              f"(specs predict {row['expected_bytes'] / 2 ** 30:.3f}; one "
              f"device {row['one_device_bytes'] / 2 ** 30:.3f}, ratio "
              f"{held / row['one_device_bytes']:.4f}; by kind "
              f"{json.dumps(row['held'])}); peak allocated "
              f"{row['peak_gib']:.2f} GiB over the steps (one device at the "
              f"same batch: {ONE_DEVICE_PEAK_GIB} GiB, phase 11c (d)); per "
              f"step [count, bytes] {json.dumps(row['collectives'])}; K6 "
              f"{row['k6_launches']} a step; step walls "
              f"{[round(w, 3) for w in row['step_s']]} s (gloo staged "
              f"through host memory on one shared card: no measure of "
              f"FSDP's speed); losses {json.dumps(row['losses'])}; grad "
              f"norms {row['grad_norm']}", flush=True)
        if held != row["expected_bytes"] or \
                not 0.5 < held / row["one_device_bytes"] < 0.55:
            raise AssertionError(f"rank {rank} holds {held} bytes; the specs "
                                 f"say {row['expected_bytes']}")
        if sorted(row["losses"]) != [0, 1, 2] or not np.isfinite(
                list(row["losses"].values())).all():
            raise AssertionError(f"rank {rank} losses {row['losses']}")
        want_k6 = whisper_train_k6(configs.get_config(FSDP_ARCH))
        if row["k6_launches"] != [want_k6] * 3:
            raise AssertionError(f"rank {rank}: K6 {row['k6_launches']} a "
                                 f"step, the path's {want_k6}")
        for c in row["collectives"]:
            if c["all_gather"][0] == 0 or c["reduce_scatter"][0] == 0:
                raise AssertionError(f"rank {rank}: no FSDP collectives {c}")
    first = got[0][FSDP_ARCH]["first"]
    print(f"[fsdp] {FSDP_ARCH} first step, two ranks / one device: loss "
          f"{first['loss'][0]:.6f} / {first['loss'][1]:.6f}, grad norm "
          f"{first['grad_norm'][0]:.6f} / {first['grad_norm'][1]:.6f}; the "
          f"gathered parameters after step 1 {first['params_rel']:.3g} "
          f"relative L2 from one device's ({first['params_rel_to_move']:.3g} "
          f"of one device's move)", flush=True)
    (l2, l1), (n2, n1) = first["loss"], first["grad_norm"]
    if abs(l2 - l1) > TRAIN_LM_LOSS_RTOL * abs(l1) or \
            abs(n2 - n1) > TRAIN_LM_GNORM_RTOL * abs(n1) or \
            not first["params_rel"] <= FSDP_PARAM_RTOL:
        raise AssertionError(f"{FSDP_ARCH}: the two-rank first step left the "
                             f"one-device bounds: {first}")
    fam = {}
    for arch, want in one_device.items():
        two = got[0]["families"][arch]
        rel = [abs(two[s] - want[s]) / abs(want[s]) for s in sorted(want)]
        fam[arch] = rel
        if got[1]["families"][arch] != two or sorted(two) != sorted(want) \
                or max(rel) > DP_RTOL:
            raise AssertionError(f"{arch} --smoke on two ranks {two} vs one "
                                 f"device {want}")
    print(f"[fsdp families] --smoke, two ranks against one device, relative "
          f"loss gap by step: {json.dumps(fam)} (in "
          f"{got[0]['families_s']:.1f} s)", flush=True)
    for rank, res in enumerate(got):
        bp = res["bp"]
        print(f"[fsdp bp] rank {rank}: bp_parallel_layer vs layer_apply "
              f"(glm4-9b layer, parallel block, bf16, S 512) max |diff| "
              f"{bp['max_abs_diff']:.3g} (output scale {bp['scale']:.3g}); "
              f"K6 {bp['k6_launches']}", flush=True)
        if bp["max_abs_diff"] > K6_ATOL + RTOL * bp["scale"] or \
                bp["k6_launches"] != (1 if rank == 0 else 0):
            raise AssertionError(f"rank {rank}: BP layer {bp}")
    return {"ranks": got, "spawn_s": spawn_s, "families": fam}


def dp_phase(dev, card: str, launcher: dict) -> dict:
    """Phase 11d: (a), then (b)-(d) (``launcher``: phase 11c (e)'s rows,
    whose card losses are the one-device runs of (c))."""
    t0 = time.perf_counter()
    out = {"defaults": af2_defaults_phase(dev)}
    t_a = time.perf_counter() - t0
    one = {arch: {int(s): v for s, v in row["card"].items()}
           for arch, row in launcher.items()}
    out["fsdp"] = fsdp_phase(dev, card, one)
    out["wall_s"] = time.perf_counter() - t0
    print(f"[dp phase] wall {out['wall_s']:.1f} s ((a) {t_a:.1f} s, the "
          f"ranks {out['fsdp']['spawn_s']:.1f} s) on {card}", flush=True)
    return out


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


# ---------------------------------------------------------------------------
# Phase 13: the dry run (launch/dryrun.py) against the card
# ---------------------------------------------------------------------------

# a predicted peak lies within this share of the measured one
DRYRUN_PEAK_RTOL = 0.10
DRYRUN_SEED = 131
# (d): an af2_tiny cell on a 2x4 virtual mesh, bp 2 x dap 2 x data 2
DRYRUN_SMALL_MESH = ((2, 4), ("data", "model"))


def measure_step(run, arguments) -> dict:
    """The memory of a second call of ``run`` (the first builds what a step
    keeps: cuBLAS workspaces, cached host constants): ``before`` (bytes
    allocated before it), ``peak`` (``max_memory_allocated`` during it),
    ``args`` (the storages of ``arguments``, the step's inputs), ``step``
    (its own peak: ``peak`` less what was allocated before beyond its
    arguments, i.e. workspaces and what earlier phases still hold) and
    ``launches``."""
    from repro_torch.kernels import ops
    run()
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    args = sum({id(st): st.nbytes() for st in (
        t.untyped_storage() for t in arguments)}.values())
    return {"before": before, "peak": peak, "args": args,
            "step": peak - (before - args), "launches": ops.launch_counts()}


def check_peak(what: str, predicted: int, measured: int, full: dict) -> float:
    """The predicted peak's relative error against the step's measured
    peak; raises past DRYRUN_PEAK_RTOL, naming the largest storages the
    trace held near its peak."""
    rel = predicted / measured - 1.0
    if abs(rel) > DRYRUN_PEAK_RTOL:
        top = ", ".join(f"{b / 2 ** 20:.1f} MiB {lab}"
                        for b, lab in full["peak_storages"][:8])
        raise AssertionError(
            f"{what}: predicted peak {predicted} B is {100 * rel:+.1f} % of "
            f"the measured {measured} B (bound {100 * DRYRUN_PEAK_RTOL:.0f} "
            f"%); the largest live storages at the trace's peak: {top}")
    return rel


def dryrun_af2(dev, card: str) -> dict:
    """(a) af2_initial's training step at full width, batch 1, one recycle,
    remat "block", K1-K5, eager on one device: measured on the card, then
    dry-run (a 1x1 virtual mesh) and held to it."""
    from repro_torch.analysis.roofline import af2_model_flops
    from repro_torch.core.config import af2_initial, with_kernels
    from repro_torch.core.model import AlphaFold2, to_device
    from repro_torch.data.protein import protein_batch
    from repro_torch.launch import dryrun
    from repro_torch.train.optim import adamw
    from repro_torch.train.trainstep import init_state, make_step_body
    cfg = with_kernels(af2_initial())
    depth = f"{cfg.n_evoformer} + {cfg.n_extra_msa_blocks} blocks"
    opt = adamw(1e-3, clip_norm=0.1)
    state = init_state(AlphaFold2(cfg, device=dev), opt)
    batch = to_device(protein_batch(DRYRUN_SEED, 0, 1, cfg), dev)
    key = torch.zeros((2,), dtype=torch.int64, device=dev)
    step = torch.ones((), device=dev)
    body = make_step_body(cfg, opt)
    t0 = time.perf_counter()
    m = measure_step(lambda: body(state, batch, key, step, 1),
                     dryrun._state_tensors(state) + list(batch.values())
                     + [step])
    card_s = time.perf_counter() - t0
    launches = m["launches"]
    del state, batch, body
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = dryrun.run_af2_cell("initial", False, bp=1, dap=1, global_batch=1,
                              probes=False, mesh=((1, 1), ("data", "model")))
    trace_s = time.perf_counter() - t0
    if rec["status"] != "ok":
        raise AssertionError(f"dry run of af2_initial: {rec.get('error')}")
    full, mem = rec["full"], rec["full"]["memory"]
    useful = 3.0 * af2_model_flops(cfg)
    nodes = {k: full["kernel_nodes"].get(k, 0) for k in launches}
    print(f"[dryrun af2] af2_initial ({depth}), batch 1, n_recycle 1, remat "
          f"block, K1-K5, one device, {card}: predicted peak "
          f"{mem['peak_bytes_estimate']} B vs the step's {m['step']} B "
          f"(max_memory_allocated {m['peak']} B less {m['before'] - m['args']}"
          f" B allocated before it beyond its arguments); predicted "
          f"arguments {mem['argument_bytes']} B vs {m['args']} B on the card "
          f"({m['before']} B allocated before the step); trace FLOPs "
          f"{full['per_device_flops']:.6g} vs 3 x af2_model_flops "
          f"{useful:.6g} (ratio {full['per_device_flops'] / useful:.4f}); "
          f"kernel launches {json.dumps(launches)} vs trace nodes "
          f"{json.dumps(nodes)}; two card steps {card_s:.1f} s, trace "
          f"{trace_s:.1f} s ({full['aten_ops']} aten ops)", flush=True)
    rel = check_peak("af2_initial", mem["peak_bytes_estimate"], m["step"],
                     full)
    if nodes != launches:
        raise AssertionError(f"af2_initial: launches {launches} != the "
                             f"trace's kernel nodes {nodes}")
    return {"depth": depth, "predicted_peak": mem["peak_bytes_estimate"],
            "measured": m, "peak_rel": rel,
            "predicted_arguments": mem["argument_bytes"],
            "flops": full["per_device_flops"],
            "model_flops": useful, "launches": launches,
            "trace_s": trace_s, "card_s": card_s}


def dryrun_whisper(dev, card: str) -> dict:
    """(b) whisper-medium's training step (TRAIN_LM_BATCH x TRAIN_LM_SEQ
    tokens, remat "layer", K6, AdamW as phase 11c) on one device: measured
    on the card, then dry-run and held to it."""
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.tokens import token_batch
    from repro_torch.launch import dryrun
    from repro_torch.models import get_model
    from repro_torch.models.lmconfig import with_kernels
    from repro_torch.parallel.ranks import virtual_world
    from repro_torch.train.optim import adamw
    from repro_torch.train.trainstep import init_lm_state, make_lm_train_step
    cfg = dataclasses.replace(with_kernels(configs.get_config(WHISPER_ARCH)),
                              remat="layer")
    lm = get_model(cfg)
    opt = adamw(TRAIN_LM_LR, clip_norm=1.0)
    state = init_lm_state(lm.init_params(cfg, seed=0, device=dev), opt)
    b = token_batch(0, 0, TRAIN_LM_BATCH, TRAIN_LM_SEQ, cfg.vocab)
    batch = {"tokens": torch.as_tensor(b["tokens"], device=dev),
             "labels": torch.as_tensor(b["labels"], device=dev),
             "frames": seeded_bf16((TRAIN_LM_BATCH, cfg.n_frontend_tokens,
                                    cfg.frontend_dim), 23, dev)}
    step = make_lm_train_step(lm, cfg, opt)
    m = measure_step(lambda: step(state, batch),
                     dryrun._state_tensors(state) + list(batch.values()))
    launches = m["launches"]
    del state, batch, step
    torch.cuda.empty_cache()
    shape = ShapeSpec("train_448", "train", TRAIN_LM_SEQ, TRAIN_LM_BATCH)
    t0 = time.perf_counter()
    with virtual_world(1):
        full = dryrun.trace_lm_step(cfg, shape, {"data": 1, "model": 1}, 1,
                                    optimizer=opt)
    trace_s = time.perf_counter() - t0
    mem = full["memory"]
    nodes = {k: full["kernel_nodes"].get(k, 0) for k in launches}
    print(f"[dryrun whisper] {WHISPER_ARCH} training step, "
          f"{TRAIN_LM_BATCH} x {TRAIN_LM_SEQ} tokens, remat layer, K6, AdamW, "
          f"one device, {card}: predicted peak {mem['peak_bytes_estimate']} B "
          f"vs the step's {m['step']} B (max_memory_allocated {m['peak']} B "
          f"less {m['before'] - m['args']} B allocated before it beyond its "
          f"arguments); predicted arguments {mem['argument_bytes']} B vs "
          f"{m['args']} B on the card; trace FLOPs "
          f"{full['per_device_flops']:.6g}; kernel launches "
          f"{json.dumps(launches)} vs trace nodes {json.dumps(nodes)}; trace "
          f"{trace_s:.1f} s ({full['aten_ops']} aten ops)", flush=True)
    rel = check_peak(WHISPER_ARCH, mem["peak_bytes_estimate"], m["step"],
                     full)
    if nodes != launches:
        raise AssertionError(f"{WHISPER_ARCH}: launches {launches} != the "
                             f"trace's kernel nodes {nodes}")
    return {"predicted_peak": mem["peak_bytes_estimate"], "measured": m,
            "peak_rel": rel, "predicted_arguments": mem["argument_bytes"],
            "flops": full["per_device_flops"],
            "launches": launches, "trace_s": trace_s}


def dryrun_meta_routes(dev) -> dict:
    """(c) each kernel's meta route (``kernels.meta``) against the kernel at
    one shape of each path: the outputs' shapes and dtypes.  (The scratch
    both allocate is ``kernels/cost.py``'s, which each launch checks against
    its kernel's layout.)"""
    from repro_torch.kernels import evo_attention as ka
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import meta as kmeta
    from repro_torch.kernels import triangle as kt
    g = torch.Generator(device=dev).manual_seed(DRYRUN_SEED)
    rn = lambda *s, dt=torch.bfloat16: torch.randn(
        s, generator=g, device=dev).to(dt)
    on_meta = lambda args: [a.to("meta") if isinstance(a, torch.Tensor)
                            else a for a in args]
    layout = lambda out: [None if t is None else (tuple(t.shape), str(t.dtype))
                          for t in (out if isinstance(out, tuple) else (out,))]
    cases = []
    # K1 / K2: af2_initial's MSA row attention (bias, gate) and a column
    # attention (no bias), bf16
    for L, S, H, C, biased in ((128, 256, 8, 32, True),
                               (256, 128, 8, 32, False)):
        q, k, v, gate, do = (rn(L, S, H, C) for _ in range(5))
        bias = rn(H, S, S) if biased else None
        out, lse = ka.evo_attention_fwd(q, k, v, bias, gate, return_lse=True)
        cases.append((f"K1 ({L},{S},{H},{C})", kmeta.evo_attention_fwd,
                      ka.evo_attention_fwd, (q, k, v, bias, gate),
                      {"return_lse": True}))
        cases.append((f"K2 ({L},{S},{H},{C})", kmeta.evo_attention_bwd,
                      ka.evo_attention_bwd,
                      (q, k, v, bias, gate, out, lse, do), {}))
    # K3 / K4 / K5: the pair rep at r 256, c_z 128, c 128, bf16
    r, c_z, c = 256, 128, 128
    x = rn(r, r, c_z)
    w = (rn(c_z, 2 * c), rn(2 * c), rn(c_z, 2 * c), rn(2 * c), rn(c), rn(c),
         rn(c, c_z), rn(c_z), rn(c_z, c_z), rn(c_z))
    s = rn(r, r, c, dt=torch.float32)
    cases += [
        ("K3 r 256", kmeta.triangle_mult_fwd, kt.triangle_mult_fwd,
         (x, x, x, *w), {"return_s": True}),
        ("K4 r 256", kmeta.triangle_mult_bwd_epilogue,
         kt.triangle_mult_bwd_epilogue, (s, x, x, *w[4:]), {}),
        ("K5 r 256", kmeta.triangle_mult_bwd_dx, kt.triangle_mult_bwd_dx,
         (s, x, x, *w[:4]), {})]
    # K6: whisper training's causal self-attention and its cross-attention
    for name, (B, S, T, H, KV, D, causal) in (
            ("K6 self", (2, 448, 448, 16, 16, 64, True)),
            ("K6 cross", (2, 448, 1500, 16, 16, 64, False))):
        cases.append((name, kmeta.flash_attention_fwd, kf.flash_attention_fwd,
                      (rn(B, S, H, D), rn(B, T, KV, D), rn(B, T, KV, D),
                       causal), {}))
    rows = {}
    for name, meta_fn, kernel, args, kwargs in cases:
        want = layout(kernel(*args, **kwargs))
        got = layout(meta_fn(*on_meta(args), **kwargs))
        if got != want:
            raise AssertionError(f"meta route {name}: {got} != the kernel's "
                                 f"{want}")
        rows[name] = want
    torch.cuda.synchronize()
    print(f"[dryrun meta] every meta route's outputs equal the kernel's "
          f"({len(rows)} calls: {json.dumps(rows)})", flush=True)
    return {"calls": len(rows)}


def dryrun_small_cell() -> dict:
    """(d) an af2_tiny cell on a 2x4 virtual mesh: the fake process group
    of this installation of torch."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    rec = dryrun.run_af2_cell("tiny", False, bp=2, dap=2, global_batch=2,
                              probes=False, mesh=DRYRUN_SMALL_MESH)
    if rec["status"] != "ok":
        raise AssertionError(f"af2_tiny on 2x4: {rec.get('error')}")
    full = rec["full"]
    print(f"[dryrun cell] af2_tiny bp 2 x dap 2 x data 2 on a 2x4 virtual "
          f"mesh: peak {full['memory']['peak_bytes_estimate']} B, "
          f"collectives {json.dumps(full['collectives'])}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"collectives": full["collectives"]}


def dryrun_tp_train() -> dict:
    """(e) phase 14 (c)'s training step (glm4-9b, TP_C_DEPTH layers, a
    (2, 2) mesh, fsdp, remat "layer", AdamW) traced for rank 0 in a
    virtual world of four ranks: its predicted peak, which phase 14 holds
    to the rank's measured peak."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.parallel.ranks import virtual_world
    from repro_torch.train.optim import adamw
    cfg = tp_config(LM_ARCH, TP_C_DEPTH, remat="layer", fsdp=True)
    shape = ShapeSpec("train_tp", "train", TP_C_SEQ, TP_C_BATCH)
    t0 = time.perf_counter()
    with virtual_world(4):
        full = dryrun.trace_lm_step(cfg, shape, {"data": 2, "model": 2}, 4,
                                    optimizer=adamw(TRAIN_LM_LR,
                                                    clip_norm=1.0))
    mem = full["memory"]
    print(f"[dryrun tp] {LM_ARCH} {TP_C_DEPTH} layers on (data 2, model 2), "
          f"rank 0: predicted peak {mem['peak_bytes_estimate']} B, "
          f"arguments {mem['argument_bytes']} B, collectives by axis "
          f"{json.dumps(full['collectives_by_axis'])}; trace "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"predicted_peak": mem["peak_bytes_estimate"], "full": full}


def dryrun_phase(dev, card: str) -> dict:
    """Phase 13: (a) af2_initial and (b) whisper-medium training steps,
    predicted by the dry run and measured on the card; (c) the kernels'
    meta routes; (d) a small cell on a virtual mesh; (e) the prediction of
    phase 14 (c)'s peak a rank."""
    t0 = time.perf_counter()
    out = {"af2": dryrun_af2(dev, card), "whisper": dryrun_whisper(dev, card),
           "meta": dryrun_meta_routes(dev), "cell": dryrun_small_cell(),
           "tp": dryrun_tp_train()}
    out["wall_s"] = time.perf_counter() - t0
    print(f"[dryrun] phase 13 in {out['wall_s']:.1f} s: predicted / measured "
          f"peak af2_initial {100 * out['af2']['peak_rel']:+.2f} %, "
          f"{WHISPER_ARCH} {100 * out['whisper']['peak_rel']:+.2f} % (bound "
          f"{100 * DRYRUN_PEAK_RTOL:.0f} %)", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 14: tensor parallelism over 'model' (parallel.tensor)
# ---------------------------------------------------------------------------

TP_RANKS = 4
# (b): glm4-9b at full width, TP_B_DEPTH layers, (1, 4), factored decode
TP_B_DEPTH, TP_B_PROMPTS, TP_B_NEW = 2, (512, 1000, 700, 300), 8
# (c): glm4-9b training at full width, (2, 2), fsdp, remat "layer"
TP_C_DEPTH, TP_C_BATCH, TP_C_SEQ = 2, 4, 1024
# (d): the other families at full width, (1, 2): a batch of two prompts,
# one prefill and TP_D_NEW - 1 decode steps
TP_D_ARCHS = ("qwen2-moe-a2.7b", "mamba2-2.7b", "zamba2-7b",
              "whisper-medium", "internvl2-26b")
TP_D_DEPTH, TP_D_PROMPT, TP_D_NEW = 2, 512, 4


def tp_config(arch: str, depth=None, **over):
    """``arch``'s config on the kernels, cut to ``depth`` layers (whisper's
    encoder too; a hybrid keeps at least one shared-block invocation)."""
    from repro_torch import configs
    from repro_torch.models.lmconfig import with_kernels
    cfg = with_kernels(configs.get_config(arch))
    if depth is not None:
        over["n_layer"] = max(depth, 1 if cfg.family != "hybrid"
                              else cfg.shared_attn_every)
        if cfg.family == "audio":
            over["n_enc_layer"] = depth
    return dataclasses.replace(cfg, **over)


def tp_meshes() -> dict:
    """The phase's meshes over the TP_RANKS ranks (every rank builds each:
    a mesh makes process groups)."""
    from repro_torch.parallel.mesh_utils import make_mesh
    return {s: make_mesh(s, ("data", "model"), ranks=range(s[0] * s[1]))
            for s in ((1, 2), (1, 4), (2, 2))}


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def spec_bytes(lm, cfg, extents: dict, itemsize: int) -> int:
    """One rank's bytes of ``cfg``'s parameters at ``itemsize`` from the
    sanitized specs of the family's rules (``launch.dryrun.local_bytes``),
    computed apart from the layout that cut them."""
    from repro_torch.launch import dryrun
    from repro_torch.train.trainstep import lm_shapes, state_shardings
    shapes = lm_shapes(lm, cfg)
    specs = state_shardings(lm, cfg, extents, shapes)["params"]
    return sum(dryrun.local_bytes(s, itemsize, specs[k], extents)
               for k, s in shapes.items())


class TPRecorder:
    """Wraps a tensor-parallel DecodeEngine's ``_insert`` / ``_prefill1`` /
    ``_decode``: for each request, each row's greedy token over the whole
    vocabulary, the row's max and its logit at ``ref[rid][i]`` (the
    one-device run's i-th token), the first row whole for the requests
    ``keep``, and the collectives of the first recorded prefill and decode
    step (the recorder's own gathers apart)."""

    def __init__(self, engine, ref: dict, keep=()):
        from repro_torch.parallel import collectives as coll
        self.engine, self.ref, self.keep, self.coll = engine, ref, keep, coll
        self.rows = collections.defaultdict(list)
        self.first, self.counts, self.rid = {}, {}, None
        self._steps = engine._insert, engine._prefill1, engine._decode
        engine._insert, engine._prefill1, engine._decode = \
            self._insert, self._prefill, self._decode

    def _full(self, logits, axis):
        from repro_torch.parallel import tensor
        with tensor.model_parallel(axis):
            return tensor.full_vocab(logits, self.engine.cfg.vocab).float()

    def _keep(self, rid, row):
        i = len(self.rows[rid])
        want = self.ref.get(rid, [])
        at = row[want[i]].item() if i < len(want) else float("nan")
        self.rows[rid].append((int(row.argmax()), row.max().item(), at))
        if i == 0 and rid in self.keep:
            self.first[rid] = row.cpu().numpy()

    def _insert(self, slot, req):
        self.rid = req.rid
        try:
            return self._steps[0](slot, req)
        finally:
            self.rid = None

    def _prefill(self, prompt):
        before = self.coll.counts()
        logits = self._steps[1](prompt)
        if self.rid is not None:
            self.counts.setdefault("prefill",
                                   _delta(before, self.coll.counts()))
            self._keep(self.rid, self._full(logits[0, -1], self.engine.tp))
        return logits

    def _decode(self, tokens):
        before = self.coll.counts()
        logits = self._steps[2](tokens)
        self.counts.setdefault("decode", _delta(before, self.coll.counts()))
        rows = self.coll.gather_rows(self._full(logits[:, 0],
                                                self.engine.decode_tp),
                                     self.engine.batch_axes)
        for i, req in enumerate(self.engine.slots):
            if req is not None:
                self._keep(req.rid, rows[i])
        return logits


def tp_engine_run(cfg, mesh, dev, prompts, new_tokens, ref, keep,
                  slots=LM_SLOTS, max_len=LM_MAX_LEN) -> dict:
    """``cfg`` served through ``DecodeEngine(mesh=...)`` on this rank: its
    slices of the seeded bf16 weights drawn on the card, the requests of
    ``prompts`` (``new_tokens`` each), K6 and the collectives counted from
    0 just before the run."""
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.parallel.mesh_utils import mesh_shape
    from repro_torch.serve import steps
    from repro_torch.serve.engine import DecodeEngine, Request
    lm = get_model(cfg)
    layout = steps.serve_layout(lm, cfg, mesh)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16,
                            cut=layout.cut)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = sum(p.numel() * p.element_size() for p in params.parameters())
    engine = DecodeEngine(lm, cfg, params, batch_slots=slots,
                          max_len=max_len, device=dev, mesh=mesh)
    rec = TPRecorder(engine, ref, keep)
    # the rank's first prefill, unrecorded (K6 and cuBLAS set up)
    engine._prefill1(torch.as_tensor(prompts[0][:64], device=dev)[None])
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    out = {"tokens": done, "rows": dict(rec.rows), "first": rec.first,
           "counts": rec.counts, "launches": ops.launch_counts(),
           "wall_s": time.perf_counter() - t0, "init_s": init_s,
           "held": held, "specs": spec_bytes(lm, cfg, mesh_shape(mesh), 2),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "heads": {"q": params.layers[0].wq.w.shape[-1] // cfg.d_head,
                     "kv": params.layers[0].wk.w.shape[-1] / cfg.d_head},
           "factored": engine.brep is not None}
    del engine, rec, params
    torch.cuda.empty_cache()
    return out


def tp_inputs(cfg, dev, batch: int, prompt: int) -> dict:
    """(d)'s prefill batch: ``batch`` seeded prompts of ``prompt`` tokens
    (whisper's prefill reads the first) and seeded frames / patches."""
    rng = np.random.default_rng(17)
    out = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, (batch, prompt), dtype=np.int64), device=dev)}
    key = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    if key:
        out[key] = seeded_bf16((batch, cfg.n_frontend_tokens,
                                cfg.frontend_dim), 19, dev)
    return out


@torch.no_grad()
def tp_functional(lm, cfg, params, inputs: dict, fed, *, mesh=None,
                  layout=None, dtype=torch.bfloat16) -> dict:
    """A batched prefill of ``inputs``, then decode steps fed ``fed`` (B,
    n - 1), the one-device run's tokens (None: the run's own greedy
    tokens): every step's logits (n, B, V) over the whole vocabulary, fp32
    on the host, its tokens, and on a mesh the prefill's and the first
    decode step's collectives and K6 launches.  Whole on one device, or
    this rank's slices on ``mesh`` (data 1) with the cache the cache rules
    give it; caches in ``dtype``."""
    from repro_torch.kernels import ops
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import tensor
    from repro_torch.parallel.mesh_utils import Axis, mesh_shape
    from repro_torch.serve import steps
    b, s = inputs["tokens"].shape
    n_front = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    max_len = n_front + s + TP_D_NEW + 1
    dev = inputs["tokens"].device
    if mesh is None:
        cache = lm.init_cache(cfg, b, max_len, dtype, device=dev)
    else:
        cache = steps.init_local_cache(lm, cfg, b, max_len, mesh_shape(mesh),
                                       layout, dtype=dtype, device=dev)
    arg = inputs if cfg.family in ("audio", "vlm") else inputs["tokens"]
    rows, toks, counts = [], [], {}
    with tensor.model_parallel(Axis(mesh, "model")):
        before = coll.counts()
        ops.reset_launch_counts()
        logits, cache = lm.prefill(params, cfg, arg, cache)
        counts["prefill"] = _delta(before, coll.counts())
        counts["k6_prefill"] = ops.launch_counts()["flash_attention_fwd"]
        for i in range(TP_D_NEW):
            row = tensor.full_vocab(logits[:, -1], cfg.vocab).float()
            rows.append(row.cpu().numpy())
            toks.append(rows[-1].argmax(-1))
            if i == TP_D_NEW - 1:
                break
            nt = torch.as_tensor(toks[-1] if fed is None else fed[:, i],
                                 device=dev)[:, None]
            before = coll.counts()
            logits, cache = lm.decode_step(params, cfg, nt, cache)
            counts.setdefault("decode", _delta(before, coll.counts()))
    return {"logits": np.stack(rows), "tokens": np.stack(toks, 1),
            "counts": counts}


def tp_rank(rank, world, dev, inp) -> dict:
    """Phase 14 (a)-(d) on one of TP_RANKS gloo ranks sharing the card."""
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.parallel import collectives as coll
    from repro_torch.serve import steps
    from repro_torch.train.optim import adamw
    from repro_torch.train.trainstep import (init_lm_state, lm_layout,
                                             lm_shapes, make_lm_train_step,
                                             param_dict)
    from repro_torch.launch import dryrun
    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = tp_meshes()
    out = {}
    t0 = time.perf_counter()
    # (a) glm4-9b serving at full size over (1, 2)
    if rank < 2:
        out["a"] = tp_engine_run(tp_config(LM_ARCH), meshes[(1, 2)], dev,
                                 inp["a"]["prompts"], LM_NEW_TOKENS,
                                 inp["a"]["ref"], LM_CHECKED)
    out["a_s"] = time.perf_counter() - t0
    # (b) glm4-9b, TP_B_DEPTH layers, (1, 4), the factored decode plan
    t0 = time.perf_counter()
    out["b"] = tp_engine_run(
        tp_config(LM_ARCH, TP_B_DEPTH, factored_decode=True), meshes[(1, 4)],
        dev, inp["b"]["prompts"], TP_B_NEW, inp["b"]["ref"], (0,),
        slots=len(TP_B_PROMPTS), max_len=max(TP_B_PROMPTS) + TP_B_NEW + 1)
    out["b_s"] = time.perf_counter() - t0
    # (c) glm4-9b training, TP_C_DEPTH layers, (2, 2), fsdp
    t0 = time.perf_counter()
    cfg = tp_config(LM_ARCH, TP_C_DEPTH, remat="layer", fsdp=True)
    lm = get_model(cfg)
    mesh = meshes[(2, 2)]
    opt = adamw(TRAIN_LM_LR, clip_norm=1.0)
    layout = lm_layout(lm, cfg, lm_shapes(lm, cfg), mesh)
    model = lm.init_params(cfg, seed=0, device=dev, cut=layout.cut)
    state = init_lm_state(model, opt, layout=layout)
    batch = tp_train_batch(cfg, dev)
    step = make_lm_train_step(lm, cfg, opt, mesh)
    ops.reset_launch_counts()
    coll.reset_counts()
    _, m = step(state, batch)
    first = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
             "launches": ops.launch_counts(), "counts": coll.counts()}
    opt_state = state["opt"]
    first["held"] = {k: layout.bytes_held(t) for k, t in (
        ("params", param_dict(state["params"])), ("mu", opt_state.mu),
        ("nu", opt_state.nu))}
    first["specs"] = 3 * spec_bytes(lm, cfg, {"data": 2, "model": 2}, 4)
    first["measured"] = measure_step(
        lambda: step(state, batch),
        dryrun._state_tensors(state) + list(batch.values()))
    out["c"] = first
    del state, model, step, batch, opt_state
    torch.cuda.empty_cache()
    out["c_s"] = time.perf_counter() - t0
    # (d) the other five families, TP_D_DEPTH layers, (1, 2)
    t0 = time.perf_counter()
    out["d"] = {}
    if rank < 2:
        for arch in TP_D_ARCHS:
            cfg = tp_config(arch, TP_D_DEPTH)
            lm = get_model(cfg)
            layout = steps.serve_layout(lm, cfg, meshes[(1, 2)])
            params = lm.init_params(cfg, seed=0, device=dev,
                                    dtype=torch.bfloat16, cut=layout.cut)
            inputs = tp_inputs(cfg, dev, 2, TP_D_PROMPT)
            res = tp_functional(lm, cfg, params, inputs,
                                inp["d"][arch]["tokens"],
                                mesh=meshes[(1, 2)], layout=layout)
            res["local"] = tp_local_width(cfg, params)
            res["held"] = sum(p.numel() * p.element_size()
                              for p in params.parameters())
            res["specs"] = spec_bytes(lm, cfg, {"data": 1, "model": 2}, 2)
            out["d"][arch] = res
            del params
            torch.cuda.empty_cache()
    out["d_s"] = time.perf_counter() - t0
    return out


def tp_local_width(cfg, params) -> dict:
    """What a rank holds of the structure (d) reports: a MoE's bank
    experts, an SSM's heads, attention's local query / KV heads."""
    lp = (params.dec_layers if cfg.family == "audio" else params.layers)[0]
    if cfg.family == "moe":
        return {"experts": lp.moe.w_gate.shape[0]}
    if cfg.family in ("ssm", "hybrid"):
        out = {"ssm_heads": lp.A_log.shape[0]}
        if cfg.family == "hybrid":
            sb = params.shared
            out["q_heads"] = sb.wq.w.shape[-1] // cfg.d_head
            out["kv_heads"] = sb.wk.w.shape[-1] // cfg.d_head
        return out
    att = lp.self_attn if hasattr(lp, "self_attn") else lp
    return {"q_heads": att.wq.w.shape[-1] // cfg.d_head,
            "kv_heads": att.wk.w.shape[-1] // cfg.d_head}


def tp_train_batch(cfg, dev) -> dict:
    from repro_torch.data.tokens import token_batch
    b = token_batch(0, 0, TP_C_BATCH, TP_C_SEQ, cfg.vocab)
    return {"tokens": torch.as_tensor(b["tokens"], device=dev),
            "labels": torch.as_tensor(b["labels"], device=dev)}


def tp_k6_per_prefill(cfg) -> int:
    """K6 launches of one prefill: whisper's encoder layers; else each
    attention call of the forward (``attention_calls``)."""
    return cfg.n_enc_layer if cfg.family == "audio" else attention_calls(cfg)


def tp_tokens_check(what: str, got: dict, want: dict, rows: dict,
                    bound: float) -> dict:
    """Tokens by request against the one-device run's: equal, or at the
    first position where they part a near tie of the tensor-parallel
    row (its max less its logit at the one-device token no more than
    ``bound``, the bf16 noise of the path); raises otherwise.  Returns
    {"differ": requests that part, "gaps": [(rid, position, gap)]}."""
    gaps = []
    for rid, ref in want.items():
        mine = list(got[rid])
        if mine == list(ref):
            continue
        p = next(i for i, (a, b) in enumerate(zip(mine, ref)) if a != b)
        _, top, at = rows[rid][p]
        gap = top - at
        gaps.append((rid, p, gap))
        if not gap <= bound:
            raise AssertionError(
                f"{what} request {rid}: token {p} is {mine[p]}, one device's "
                f"{ref[p]}, {gap:.4g} below the row's max (bf16 noise bound "
                f"{bound:.4g})")
    return {"differ": len(gaps), "gaps": gaps}


def tp_one_device_refs(dev, phase11: dict) -> dict:
    """The one-device runs (b)-(d) are held to, made on the card before the
    ranks start (and freed): (b) glm4-9b at TP_B_DEPTH layers through
    DecodeEngine, its tokens, request 0's plain fp32 logits and the plain
    bf16 path's distance from them; (c) the first training step's loss and
    gradient norm; (d) each family's tokens, bf16 logits and the fp32
    value of the same bf16 weights (compute and caches in fp32, fed the
    bf16 run's tokens)."""
    from repro_torch.models import dense, get_model
    from repro_torch.serve.engine import DecodeEngine, Request
    from repro_torch.train.optim import adamw
    from repro_torch.train.trainstep import init_lm_state, make_lm_train_step
    out = {}
    cfg = tp_config(LM_ARCH, TP_B_DEPTH, factored_decode=True)
    lm = get_model(cfg)
    params = lm.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in TP_B_PROMPTS]
    engine = DecodeEngine(lm, cfg, params, batch_slots=len(TP_B_PROMPTS),
                          max_len=max(TP_B_PROMPTS) + TP_B_NEW + 1,
                          device=dev, graphs=False)
    done = engine.run([Request(rid=i, prompt=p, max_new_tokens=TP_B_NEW)
                       for i, p in enumerate(prompts)])
    tokens = torch.as_tensor(np.concatenate([prompts[0], done[0][:-1]]),
                             device=dev)[None]
    start = len(prompts[0]) - 1
    ref32 = plain_lm_logits(engine.params, cfg, tokens, start, torch.float32)
    noise = (plain_lm_logits(engine.params, cfg, tokens, start,
                             torch.bfloat16) - ref32).abs().max().item()
    out["b"] = {"prompts": prompts, "tokens": done,
                "first": ref32[0].cpu().numpy(), "noise": noise}
    del engine, params, ref32
    torch.cuda.empty_cache()
    cfg = tp_config(LM_ARCH, TP_C_DEPTH, remat="layer", fsdp=True)
    lm = get_model(cfg)
    opt = adamw(TRAIN_LM_LR, clip_norm=1.0)
    state = init_lm_state(lm.init_params(cfg, seed=0, device=dev), opt)
    _, m = make_lm_train_step(lm, cfg, opt)(state, tp_train_batch(cfg, dev))
    out["c"] = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item()}
    del state, m
    torch.cuda.empty_cache()
    out["d"] = {}
    for arch in TP_D_ARCHS:
        cfg = tp_config(arch, TP_D_DEPTH)
        lm = get_model(cfg)
        params = lm.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
        inputs = tp_inputs(cfg, dev, 2, TP_D_PROMPT)
        bf = tp_functional(lm, cfg, params, inputs, None)
        fed = bf["tokens"][:, :-1]
        with compute_dtype(lm, torch.float32), \
                compute_dtype(dense, torch.float32):
            f32 = tp_functional(lm, cfg, params, inputs, fed,
                                dtype=torch.float32)
        out["d"][arch] = {"tokens": bf["tokens"], "fed": fed,
                          "logits32": f32["logits"],
                          "noise": np.abs(bf["logits"] - f32["logits"]).max()}
        del params, inputs
        torch.cuda.empty_cache()
    return out


def tp_phase(dev, card: str, phase11: dict, dry_tp: dict) -> dict:
    """Phase 14: tensor parallelism over 'model' on TP_RANKS gloo ranks
    sharing the card (eager; ranks on one card talk through host memory, so
    no wall here measures tensor parallelism's speed).  ``phase11``: phase
    11's requests, eager tokens and plain-path values (``refs``);
    ``dry_tp``: phase 13's prediction of (c)'s peak."""
    from repro_torch.parallel import ranks as ranks_lib
    t_start = time.perf_counter()
    k6_rows, k6_tot = check_flash_attention(dev, [
        ("tp_prefill_S3000_H16_KV1", (1, 3000, 3000, 16, 1, 128), True,
         torch.bfloat16, tp_config(LM_ARCH).n_layer
         * sum(n == 3000 for n in LM_PROMPTS))])
    for row in k6_rows:
        print(f"[tp kernel] flash_attention_fwd {json.dumps(row)}",
              flush=True)
    t0 = time.perf_counter()
    refs = tp_one_device_refs(dev, phase11)
    refs_s = time.perf_counter() - t0
    reqs, done11 = phase11["reqs"], phase11["tokens"]
    inp = {"a": {"prompts": [r.prompt for r in reqs],
                 "ref": {rid: list(t) for rid, t in done11.items()}},
           "b": {"prompts": refs["b"]["prompts"],
                 "ref": {rid: list(t) for rid, t in
                         refs["b"]["tokens"].items()}},
           "d": {a: {"tokens": r["fed"]} for a, r in refs["d"].items()}}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = ranks_lib.spawn(tp_rank, TP_RANKS, inp, device_type=dev.type,
                          backend="gloo", timeout_s=900)
    spawn_s = time.perf_counter() - t0
    out = {"refs_s": refs_s, "spawn_s": spawn_s, "k6_row": k6_rows[0]}
    # (a)
    cfg = tp_config(LM_ARCH)
    per = {key[0]: val for key, val in phase11["refs"].items()}
    noise = max(v[1] for v in per.values())
    for rank in (0, 1):
        a = got[rank]["a"]
        want = {"flash_attention_fwd": cfg.n_layer * len(reqs)}
        launches = {k: v for k, v in a["launches"].items() if v}
        heads = {"q": cfg.n_head // 2, "kv": cfg.n_kv_head / 2}
        if launches != want or a["held"] != a["specs"] or \
                a["heads"] != heads:
            raise AssertionError(f"(a) rank {rank}: launches {launches} "
                                 f"(want {want}), holds {a['held']} B (specs "
                                 f"{a['specs']}), heads {a['heads']}")
        toks = tp_tokens_check("(a)", a["tokens"], done11, a["rows"],
                               LM_NOISE_FACTOR * noise)
        first = {}
        for rid, (ref32, nz, _) in per.items():
            err = np.abs(a["first"][rid] - ref32[0].cpu().numpy()).max()
            first[rid] = (err, nz)
            if not err <= LM_NOISE_FACTOR * nz:
                raise AssertionError(f"(a) rank {rank} request {rid}: first "
                                     f"logits {err} from fp32, over "
                                     f"{LM_NOISE_FACTOR} x {nz}")
        print(f"[tp a] {LM_ARCH} serving, {cfg.n_layer} layers, mesh (data "
              f"1, model 2), rank {rank} of 2 ({card}): {a['heads']['q']} "
              f"query / {a['heads']['kv']:g} KV heads a rank; holds "
              f"{a['held']} B of bf16 weights (specs {a['specs']} B); K6 "
              f"{a['launches']['flash_attention_fwd']} launches over "
              f"{len(reqs)} prefills; a prefill's collectives "
              f"{json.dumps(a['counts']['prefill'])}, a decode step's "
              f"{json.dumps(a['counts']['decode'])}; tokens against phase "
              f"11's: {toks['differ']} of {len(done11)} requests part "
              f"(first-part gaps {toks['gaps']}); first-token logits vs fp32 "
              f"(rid: max |diff|, plain bf16's) {first}; drawn in "
              f"{a['init_s']:.1f} s, served in {a['wall_s']:.1f} s, peak "
              f"{a['peak_gib']:.2f} GiB", flush=True)
    out["a"] = {"launches": got[0]["a"]["launches"]["flash_attention_fwd"],
                "counts": got[0]["a"]["counts"], "held": got[0]["a"]["held"]}
    # (b)
    rb = refs["b"]
    cfg_b = tp_config(LM_ARCH, TP_B_DEPTH, factored_decode=True)
    for rank in range(TP_RANKS):
        b = got[rank]["b"]
        want = {"flash_attention_fwd": cfg_b.n_layer * len(TP_B_PROMPTS)}
        launches = {k: v for k, v in b["launches"].items() if v}
        if launches != want or b["held"] != b["specs"] or not b["factored"]:
            raise AssertionError(f"(b) rank {rank}: launches {launches}, "
                                 f"holds {b['held']} (specs {b['specs']}), "
                                 f"factored {b['factored']}")
        toks = tp_tokens_check("(b)", b["tokens"], rb["tokens"], b["rows"],
                               LM_NOISE_FACTOR * rb["noise"])
        err = np.abs(b["first"][0] - rb["first"]).max()
        if not err <= LM_NOISE_FACTOR * rb["noise"]:
            raise AssertionError(f"(b) rank {rank}: first logits {err} from "
                                 f"fp32, over {LM_NOISE_FACTOR} x "
                                 f"{rb['noise']}")
        print(f"[tp b] {LM_ARCH} {TP_B_DEPTH} layers, mesh (data 1, model "
              f"4), factored decode (kvh 2, brep 2), rank {rank}: "
              f"{b['heads']['q']} query / {b['heads']['kv']:g} KV heads a "
              f"rank (KV split inside a head); K6 "
              f"{b['launches']['flash_attention_fwd']}; a prefill's "
              f"collectives {json.dumps(b['counts']['prefill'])}, a decode "
              f"step's {json.dumps(b['counts']['decode'])}; tokens against "
              f"one device's: {toks['differ']} of {len(rb['tokens'])} part "
              f"{toks['gaps']}; first logits {err:.4g} from fp32 (plain "
              f"bf16 {rb['noise']:.4g})", flush=True)
    out["b"] = {"launches": got[0]["b"]["launches"]["flash_attention_fwd"]}
    # (c)
    cfg_c = tp_config(LM_ARCH, TP_C_DEPTH, remat="layer", fsdp=True)
    one = refs["c"]
    c0 = got[0]["c"]
    for rank in range(TP_RANKS):
        c = got[rank]["c"]
        held = sum(sum(v.values()) for v in c["held"].values())
        want_k6 = 2 * attention_calls(cfg_c)
        if (c["loss"], c["grad_norm"]) != (c0["loss"], c0["grad_norm"]) or \
                held != c["specs"] or \
                c["launches"]["flash_attention_fwd"] != want_k6:
            raise AssertionError(f"(c) rank {rank}: loss {c['loss']} grad "
                                 f"norm {c['grad_norm']}, holds {held} "
                                 f"(specs {c['specs']}), K6 "
                                 f"{c['launches']} (want {want_k6})")
    if abs(c0["loss"] - one["loss"]) > TRAIN_LM_LOSS_RTOL * abs(one["loss"]) \
            or abs(c0["grad_norm"] - one["grad_norm"]) > \
            TRAIN_LM_GNORM_RTOL * abs(one["grad_norm"]):
        raise AssertionError(f"(c) first step {c0['loss']} / "
                             f"{c0['grad_norm']} vs one device {one}")
    meas = c0["measured"]
    rel = check_peak(f"{LM_ARCH} (2, 2) rank 0", dry_tp["predicted_peak"],
                     meas["step"], dry_tp["full"])
    print(f"[tp c] {LM_ARCH} training, {TP_C_DEPTH} layers, {TP_C_BATCH} x "
          f"{TP_C_SEQ} tokens, mesh (data 2, model 2), fsdp, remat layer, "
          f"AdamW ({card}): first loss {c0['loss']:.6f} (one device "
          f"{one['loss']:.6f}), grad norm {c0['grad_norm']:.6f} (one device "
          f"{one['grad_norm']:.6f}); rank 0 holds {json.dumps(c0['held'])} "
          f"(specs: {c0['specs']} B of parameters + mu + nu); K6 "
          f"{c0['launches']['flash_attention_fwd']} a step; collectives of "
          f"the step {json.dumps(c0['counts'])}; peak: predicted by phase 13 "
          f"{dry_tp['predicted_peak']} B, measured {meas['step']} B "
          f"({100 * rel:+.2f} %)", flush=True)
    out["c"] = {"launches": c0["launches"]["flash_attention_fwd"],
                "peak_rel": rel}
    # (d)
    out["d"] = {}
    for arch in TP_D_ARCHS:
        cfg = tp_config(arch, TP_D_DEPTH)
        r = refs["d"][arch]
        bound = LM_NOISE_FACTOR * r["noise"]
        for rank in (0, 1):
            d = got[rank]["d"][arch]
            err = np.abs(d["logits"] - r["logits32"]).max()
            rows = {i: [(0, d["logits"][p, i].max(),
                         d["logits"][p, i, r["tokens"][i, p]])
                        for p in range(TP_D_NEW)] for i in range(2)}
            toks = tp_tokens_check(
                f"(d) {arch}", {i: d["tokens"][i].tolist() for i in range(2)},
                {i: r["tokens"][i].tolist() for i in range(2)}, rows, bound)
            k6 = d["counts"]["k6_prefill"]
            if not err <= bound or k6 != tp_k6_per_prefill(cfg) or \
                    d["held"] != d["specs"]:
                raise AssertionError(f"(d) {arch} rank {rank}: logits {err} "
                                     f"from fp32 (bound {bound}), K6 {k6} "
                                     f"(want {tp_k6_per_prefill(cfg)}), "
                                     f"holds {d['held']} (specs "
                                     f"{d['specs']})")
        print(f"[tp d] {arch} {cfg.n_layer} layers, mesh (data 1, model 2): "
              f"a rank holds {json.dumps(d['local'])}; logits vs fp32 "
              f"{err:.4g} (plain bf16 one device {r['noise']:.4g}); tokens "
              f"part in {toks['differ']} of 2 rows {toks['gaps']}; K6 {k6} a "
              f"prefill; collectives a prefill "
              f"{json.dumps(d['counts']['prefill'])}, a decode step "
              f"{json.dumps(d['counts']['decode'])}", flush=True)
        out["d"][arch] = {"k6": k6, "local": d["local"]}
    out["wall_s"] = time.perf_counter() - t_start
    walls = {k: round(got[0][k + "_s"], 1) for k in "abcd"}
    print(f"[tp phase] wall {out['wall_s']:.1f} s (one-device references "
          f"{refs_s:.1f} s, ranks {spawn_s:.1f} s: rank 0 by part "
          f"{json.dumps(walls)}) on {card}", flush=True)
    return out


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
    tcfg = train_cfg(cfg)
    for tag, use in (("eager", False), ("eager again", False),
                     ("graphed", True)):
        runs[tag] = train_main_path(tcfg, dev, graphs=use,
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
    res = check_resume(tcfg, dev, bound)
    st = res["stats"]
    print(f"[train resume] run A {RESUME_STEPS} graphed steps "
          f"({tcfg.n_evoformer} + {tcfg.n_extra_msa_blocks} blocks, n_recycle "
          f"1, FASTA records), checkpoints at {RESUME_AT} and {RESUME_STEPS}: "
          f"{res['bytes']} bytes on disk each; snapshot s {st['A']['snapshot_s']}, "
          f"save s {st['A']['save_s']}; run B restored step {RESUME_AT} in "
          f"{st['B']['restore_s']} s; max |diff| vs run A: B {json.dumps(res['b'])}, "
          f"C (run A's runner, restored into its graph) {json.dumps(res['c'])}; "
          f"bound {bound}; train_compiles unchanged on restore; step walls A "
          f"{[round(x, 3) for x in res['a_step_s']]}, B "
          f"{[round(x, 3) for x in res['b_step_s']]}, C "
          f"{[round(x, 3) for x in res['c_step_s']]} s; run A's data "
          f"{json.dumps(res['a_data'])}", flush=True)
    rm = check_remat_dots(tcfg, dev, bound)
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
    del lm_engine, lm_rec, lm_weights    # the recorder holds the engine
    torch.cuda.empty_cache()
    # phase 11b: K6 at zamba2-7b's head dim 112, then the moe, ssm and
    # hybrid families through the LM path, then the serve launcher's ranks
    d112_rows, d112_tot = check_flash_attention(
        dev, d112_kernel_shapes(configs.get_config("zamba2-7b")))
    for row in d112_rows:
        print(f"[lm kernel] flash_attention_fwd {json.dumps(row)}", flush=True)
    print(f"[lm kernel total] K6 at D 112 over zamba2-7b's prefills in "
          f"phase 11b: {json.dumps(d112_tot)}", flush=True)
    families = {}
    for arch in FAMILY_ARCHS:
        families[arch] = family_phase(arch, dev)
        stamp(f"phase 11b {arch}")
    fold_launcher_phase()
    stamp("phase 11b")
    # phase 11c: whisper-medium and internvl2-26b serving, whisper-medium
    # training, the train launcher for every LM family
    av = av_phase(dev)
    stamp("phase 11c")
    # phase 11d: the AF2 default impls, LM data-parallel FSDP training
    # over two gloo ranks, bp_parallel_layer
    dp = dp_phase(dev, card, av["launcher"])
    stamp("phase 11d")
    lint_phase(dev, card)
    stamp("phase 12")
    torch.cuda.empty_cache()
    dry = dryrun_phase(dev, card)
    stamp("phase 13")
    # phase 14: tensor parallelism over 'model' on four gloo ranks
    tp = tp_phase(dev, card, {"reqs": lm_reqs, "tokens": e_done,
                              "refs": refs}, dry["tp"])
    stamp("phase 14")

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
    # K2, K4, K5: launches of phase 13 (a)'s af2_initial step at its full
    # depth, one sample-cycle (n_recycle 1), as their times and bounds are
    # priced; phase 9's runs, at TRAIN_DEPTH, under "launches_by_path"
    train_per = ("the backward of one af2_initial training sample-cycle "
                 f"({dry['af2']['depth']}; launches: phase 13 (a)'s step)")
    t_launches = dry["af2"]["launches"]
    t_path = (f"phase 9 training main path, {tcfg.n_evoformer} + "
              f"{tcfg.n_extra_msa_blocks} blocks, graphed run")
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
        {**entry("evo_attention_bwd",
                 "src/repro_torch/csrc/evo_attention_bwd.cu",
                 "src/repro/kernels/flash_attention.py:347", att_tot["k2"],
                 att_tot["k2"]["err"], t_launches["evo_attention_bwd"],
                 train_per),
         "launches_by_path": {t_path: t_counts["evo_attention_bwd"]}},
        {**entry("triangle_mult_bwd_epilogue",
                 "src/repro_torch/csrc/triangle_mult_bwd.cu",
                 "src/repro/kernels/triangle.py:239", tri_tot["k4"],
                 tri_tot["k4"]["err"],
                 t_launches["triangle_mult_bwd_epilogue"], train_per),
         "products_ms": tri_tot["k4"]["products_ms"],
         "launches_by_path": {
             t_path: t_counts["triangle_mult_bwd_epilogue"]}},
        {**entry("triangle_mult_bwd_dx",
                 "src/repro_torch/csrc/triangle_mult_bwd.cu",
                 "src/repro/kernels/triangle.py:319", tri_tot["k5"],
                 tri_tot["k5"]["err"], t_launches["triangle_mult_bwd_dx"],
                 train_per),
         "launches_by_path": {t_path: t_counts["triangle_mult_bwd_dx"]}},
        entry("flash_attention_fwd",
              "src/repro_torch/csrc/flash_attention_fwd.cu",
              "src/repro/kernels/flash_attention.py:77", k6_tot,
              k6_tot["err"], lm_counts["flash_attention_fwd"],
              f"the prefills of the {LM_ARCH} main path (8 prompts x "
              f"{lm_cfg.n_layer} layers)"),
    ]
    # K6 on phase 11b's paths: launches of each family's graphed run, and
    # its D-112 times over zamba2-7b's prefills
    kernels[-1]["launches_by_path"] = {
        LM_ARCH: lm_counts["flash_attention_fwd"],
        **{a: r["graphed"]["k6_launches"] for a, r in families.items()}}
    d112_ops = d112_tot["flops"] / PEAK_BF16_FLOPS >= \
        d112_tot["bytes"] / PEAK_BYTES
    kernels[-1]["d112"] = {
        "launches": families["zamba2-7b"]["graphed"]["k6_launches"],
        "max_abs_err": d112_tot["err"], "ms": d112_tot["ms"],
        "plain_ms": d112_tot["plain_ms"], "bound_ms": d112_tot["bound_ms"],
        "bound_by": "operations" if d112_ops else "bytes",
        "library_ms": d112_tot["library_ms"],
        "per": "the prefills of phase 11b's zamba2-7b path (4 prompts x "
               "14 shared-block invocations)"}
    # K6 on phase 11c's paths: launches a prefill (whisper's encoder,
    # internvl2's layers) and a whisper training step, and its times at
    # those shapes
    kernels[-1]["launches_by_path"].update({
        f"{WHISPER_ARCH} prefill": av[WHISPER_ARCH]["graphed"][
            "k6_launches_a_prefill"],
        f"{VLM_ARCH} prefill": av[VLM_ARCH]["graphed"][
            "k6_launches_a_prefill"],
        f"{WHISPER_ARCH} train step": av["train"]["k6_launches_a_step"],
        f"{FSDP_ARCH} FSDP train step, each of {FSDP_RANKS} ranks":
            dp["fsdp"]["ranks"][0][FSDP_ARCH]["k6_launches"][0]})
    # K6 on phase 14's tensor-parallel paths (launches a rank), and its
    # time at (a)'s local shape
    kernels[-1]["launches_by_path"].update({
        f"{LM_ARCH} tensor-parallel serving (data 1, model 2), each of 2 "
        f"ranks, {len(LM_PROMPTS)} prefills": tp["a"]["launches"],
        f"{LM_ARCH} {TP_B_DEPTH} layers (data 1, model 4), each of 4 ranks, "
        f"{len(TP_B_PROMPTS)} prefills": tp["b"]["launches"],
        f"{LM_ARCH} {TP_C_DEPTH}-layer train step (data 2, model 2), each of "
        f"4 ranks": tp["c"]["launches"],
        **{f"{a} prefill (data 1, model 2), each of 2 ranks": r["k6"]
           for a, r in tp["d"].items()}})
    kernels[-1]["tp_shape"] = {k: tp["k6_row"][k] for k in (
        "shape", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms")}
    kernels[-1]["phase_11c_shapes"] = {
        r["shape"]: {k: r[k] for k in ("launches", "max_abs_err", "ms",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")}
        for r in av["k6_rows"]}
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
