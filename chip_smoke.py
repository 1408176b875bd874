#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (exit code != 0, no result line):
  1. device: the card's name and power limit (nvidia-smi); TF32 off.
  2. build: every CUDA source under src/repro_torch/csrc with nvcc, in
     parallel, into build/repro_torch_kernels.
  3. kernels: each hand-written kernel against its plain PyTorch version at
     every shape the serving path gives it, in every bucket of the engine's
     af2_initial table, plus ragged shapes; max |diff|, kernel / plain /
     library times (CUDA events) and the bound.
  4. small fold: an af2_tiny fold through the kernels on the card against
     the same fold on the CPU through the plain versions, fp32 and bf16.
  5. main path: FoldEngine at af2_initial width and depth (48 + 4 blocks,
     c_m 256, c_z 128, largest bucket r 256 s 128 se 1024), seeded random
     weights, 4 requests over 2 buckets, micro-batch 2, 3 recycles; the
     kernels' launch counters must equal what the path implies.
  6. profile: one more largest-bucket step of the main path's engine,
     plain and under torch.profiler (device busy time, idle share, time by
     kernel family).
Then one JSON line of kernel figures, the nvidia-smi line, and the result
line ``{"ok": true, "device": {...}}`` last.
"""
import copy
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# kernel vs plain version: |diff| <= ATOL + RTOL * |plain|, bf16 outputs
# (the reference's bf16 tolerance, plus one bf16 ulp relative)
ATOL, RTOL = 3e-2, 2.0 ** -7


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


def check_close(got, want, what: str) -> float:
    d = (got.float() - want.float()).abs()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    excess = (d - ATOL - RTOL * want.float().abs()).max().item()
    err = d.max().item()
    if excess > 0:
        raise AssertionError(f"{what}: max |diff| {err} over tolerance "
                             f"(atol {ATOL}, rtol {RTOL})")
    return err


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
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
        errs.append(err)
        iters = 20 if L * S * S * H < 2 ** 27 else 5
        ms = cuda_time(lambda: ka.evo_attention_fwd(q, k, v, bias, gate), iters)
        plain_ms = cuda_time(lambda: ref.evo_attention_ref(q, k, v, bias, gate), 3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # (L, H, S, C)
        mask = None if bias is None else bias.to(torch.bfloat16)
        lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), iters)
        flops = 4.0 * L * H * S * S * C
        nbytes = 5 * L * S * H * C * 2 + (H * S * S * 4 if masked else 0)
        b_ms, b_by = bound(flops, nbytes)
        rows.append(dict(shape=name, bucket_r=bucket_r, L=L, S=S, H=H, C=C,
                         masked=masked, per_cycle=per_cycle,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", b_ms),
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
        errs.append(err)
        ms = cuda_time(lambda: kt.triangle_mult_fwd(xab, xab, x, *w, k_mask=km), 10)
        plain_ms = cuda_time(lambda: ref.triangle_mult_ref(xab, xab, x, *w, k_mask=km), 3)
        a = ref.gated_projection(xab, w[0], w[1]).to(torch.bfloat16)
        lib_ms = cuda_time(lambda: torch.einsum("ikc,jkc->ijc", a, a), 10)
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
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", b_ms),
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


def main_path(cfg, dev, *, n_requests=4, micro_batch=2, max_recycle=3):
    """Serve ``n_requests`` folds through FoldEngine; returns (results,
    engine, launch counts of this run, wall seconds)."""
    from repro_torch.data.synthetic import make_fold_requests
    from repro_torch.kernels import ops
    from repro_torch.serve.fold_engine import FoldEngine
    model = seeded_model(cfg, seed=0)
    engine = FoldEngine(cfg, model, micro_batch=micro_batch,
                        max_recycle=max_recycle, tol=0.0, device=dev)
    reqs = make_fold_requests(cfg, n_requests, seed=0)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    return reqs, done, engine, counts, wall


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
    want = {"evo_attention_fwd": k1 * sample_cycles,
            "triangle_mult_fwd": k3 * sample_cycles}
    assert counts == want, f"launches {counts} != path's {want}"
    return sample_cycles


# ---------------------------------------------------------------------------
# Phase 6: where a main-path step's time goes
# ---------------------------------------------------------------------------

def kernel_family(name: str) -> str:
    n = name.lower()
    if "evo_attention" in n:
        return "K1 evo_attention_fwd"
    if "tri_proj" in n:
        return "K3 gated projections"
    if "tri_contract" in n:
        return "K3 contraction + epilogue"
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


def profile_step(engine, reqs, done):
    """Serve the main path's largest-bucket requests again (warm, same model
    and inputs): once plain, once under torch.profiler.  Prints both walls,
    the device's busy time (union of kernel intervals) and its idle share of
    the profiled wall, device time by kernel family and the top kernels.
    The Chrome trace goes to build/profile/fold_trace.json."""
    from torch.profiler import ProfilerActivity, profile
    top = max(res.bucket for res in done.values())
    group = [r for r in reqs if done[r.rid].bucket == top]

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run(group)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    wall_plain = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = run()
    path = ROOT / "build" / "profile" / "fold_trace.json"
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
    print(f"[profile] bucket {top.describe()}, {len(group)} requests x "
          f"{engine.max_recycle} recycles: wall {wall_plain:.1f} ms plain, "
          f"{wall_prof:.1f} ms under the profiler; device busy {busy:.1f} ms, "
          f"idle share {1 - busy / wall_prof:.3f} of the profiled wall; "
          f"{len(kernels)} kernel launches", flush=True)
    for f, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"[profile family] {ms:10.2f} ms  {ms / busy:6.3f}  {f}")
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:20]:
        print(f"[profile kernel] {ms:10.2f} ms  {n:6d}  {name[:110]}")


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

    reqs, done, engine, counts, wall = main_path(cfg, dev)
    sample_cycles = check_main_path(cfg, reqs, done, engine, counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = [s["seconds"] / s["steps"]
              for s in engine.stats["per_bucket"].values()]
    print(f"[main path] af2_initial (48+4 blocks): {len(done)} folds over "
          f"{engine.last_stats['steps']} steps in {wall:.2f}s = "
          f"{len(done) / wall:.3f} folds/s; per-step latency by bucket "
          f"{[round(s, 3) for s in step_s]} s; {sample_cycles} sample-cycles; "
          f"peak memory {peak_gib:.2f} GiB; launches {counts}", flush=True)
    profile_step(engine, reqs, done)

    def entry(name, source, replaces, tot, err):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": counts[name],
                "max_abs_err": err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                "bound_ms": tot["bound_ms"],
                "bound_by": ("operations" if tot["flops"] / PEAK_BF16_FLOPS
                             >= tot["bytes"] / PEAK_BYTES else "bytes"),
                "library_ms": tot["library_ms"],
                "per": "one sample-cycle of af2_initial launches, bucket "
                       "r 256"}
    kernels = [
        entry("evo_attention_fwd", "src/repro_torch/csrc/evo_attention_fwd.cu",
              "src/repro/kernels/flash_attention.py:181", k1_tot, k1_err),
        entry("triangle_mult_fwd", "src/repro_torch/csrc/triangle_mult_fwd.cu",
              "src/repro/kernels/triangle.py:128", k3_tot, k3_err),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
