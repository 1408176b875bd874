#!/usr/bin/env python3
"""Time the attention kernels K6 (LM prefill flash forward) and K2 (Evoformer
gated-bias backward) at their main-path shapes on one NVIDIA GPU, beside
their library yardsticks, and check each against its plain version.

    python3 scripts/attention_bench.py [--only k6|k2] [--repeats 5] [--profile]

K6: glm4-9b prefills (S 512, 1000, 2048, 3000; 32 query heads over 2 KV
heads, D 128), 80 launches per prompt length on the LM main path (40 layers
x 2 prompts); yardstick SDPA with is_causal and enable_gqa.  K2: the
af2_initial training shapes with their launches per sample-cycle;
yardstick SDPA's autograd backward (dq, dk, dv) with the memory-efficient
backend pinned.  Times are medians of ``--repeats`` CUDA-event runs with
their min-max; the path totals weight each shape by its launches.  The
same numbers come from ``chip_smoke.py`` phases 7 and 10; this script runs
only them (about a minute with the build).
"""
import argparse
import json
import pathlib
import sys

import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PROFILE = False


def stages(tag, fn):
    """Device microseconds of each kernel one call of ``fn`` launches."""
    if not PROFILE:
        return
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            per[e.key[:60]] = round(e.device_time_total, 1)
    print(f"[stages {tag}] {json.dumps(per)}", flush=True)


def bench_k6(dev, repeats, check=True):
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(13)
    tot = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for S in (512, 1000, 2048, 3000):
        q = cs._rand(g, (1, S, 32, 128), torch.bfloat16)
        k, v = (cs._rand(g, (1, S, 2, 128), torch.bfloat16) for _ in range(2))
        got = kf.flash_attention_fwd(q, k, v, True)
        want = ref.flash_attention_ref(q, k, v, True)
        err = needed = None
        if check:
            err = cs.check_close(got, want, f"K6 S{S}", atol=cs.K6_ATOL)
            needed = cs.atol_needed(got, want, cs.RTOL)
        ms = cs.cuda_median(lambda: kf.flash_attention_fwd(q, k, v, True), 10,
                            repeats)
        stages(f"K6 S{S}", lambda: kf.flash_attention_fwd(q, k, v, True))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = cs.cuda_median(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 10, repeats)
        flops = 4.0 * 32 * 128 * cs.causal_pairs(S, S)
        b_ms, _ = cs.bound(flops, (2 * S * 32 + 2 * S * 2) * 128 * 2)
        print(f"[bench K6] S {S}: {json.dumps(dict(max_abs_err=err, atol_needed=needed, **cs.timed_fields('ms', ms), **cs.timed_fields('library_ms', lib), bound_ms=b_ms, tflops=flops / ms[0] / 1e9, library_tflops=flops / lib[0] / 1e9))}",
              flush=True)
        for key, val in (("ms", ms[0]), ("library_ms", lib[0]), ("bound_ms", b_ms)):
            tot[key] += 80 * val
    print(f"[bench K6 total] 320 launches: {json.dumps(tot)}; kernel / "
          f"library {tot['ms'] / tot['library_ms']:.3f}", flush=True)


def bench_k2(dev, repeats, check=True):
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.core.config import af2_initial
    from repro_torch.kernels import evo_attention as ka
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(7)
    att, _ = cs.train_shapes(af2_initial())
    tot = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for name, (L, S, H, C), per, biased in att:
        if not per:
            continue
        q, k, v, gate, do = (cs._rand(g, (L, S, H, C), torch.bfloat16)
                             for _ in range(5))
        bias = cs._rand(g, (H, S, S), torch.bfloat16) if biased else None
        out, lse = ref.evo_attention_ref(q, k, v, bias, gate, return_lse=True)
        got = ka.evo_attention_bwd(q, k, v, bias, gate, out, lse, do)
        want = ref.evo_attention_bwd_ref(q, k, v, bias, gate, out, lse, do)
        err = None
        if check:
            err = max(cs.check_grad_close(a, b, f"K2 {name}", 2.0 ** -7 * max(
                1.0, b.abs().max().item()) if b is not None and b.dtype == torch.bfloat16
                else 0.0) for a, b in zip(got, want))
        del got, want
        ms = cs.cuda_median(lambda: ka.evo_attention_bwd(
            q, k, v, bias, gate, out, lse, do), 10, repeats)
        stages(f"K2 {name}", lambda: ka.evo_attention_bwd(
            q, k, v, bias, gate, out, lse, do))
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)
            lib = cs.cuda_median(lambda: torch.autograd.grad(
                o_lib, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 10,
                repeats)
        act = L * S * H * C * 2
        nbytes = 10 * act + (H * S * S * 6 if biased else 0) + L * H * S * 4
        b_ms, _ = cs.bound(10.0 * L * H * S * S * C, nbytes)
        print(f"[bench K2] {name} {(L, S, H, C)} x{per}: {json.dumps(dict(max_abs_err=err, **cs.timed_fields('ms', ms), **cs.timed_fields('library_ms', lib), bound_ms=b_ms, gbps=nbytes / ms[0] / 1e6))}",
              flush=True)
        for key, val in (("ms", ms[0]), ("library_ms", lib[0]), ("bound_ms", b_ms)):
            tot[key] += per * val
        del q, k, v, gate, do, bias, out, lse, o_lib, qt, kt, vt
        torch.cuda.empty_cache()
    print(f"[bench K2 total] per training sample-cycle: {json.dumps(tot)}; "
          f"kernel / library {tot['ms'] / tot['library_ms']:.3f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("k6", "k2"))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    global PROFILE
    PROFILE = args.profile
    if not torch.cuda.is_available():
        raise SystemExit("attention_bench.py: no CUDA device visible")
    from repro_torch.kernels import build
    print(f"[device] {cs.device_line()}", flush=True)
    print(f"[build] {build.build_all(('flash_attention_fwd', 'evo_attention_bwd')):.1f}s")
    for name in ("flash_attention_fwd", "evo_attention_bwd"):
        for line in build.ptxas_report(name).splitlines():
            print(f"[build] {name}: {line.strip()}")
    dev = torch.device("cuda")
    if args.only in (None, "k6"):
        bench_k6(dev, args.repeats)
    if args.only in (None, "k2"):
        bench_k2(dev, args.repeats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
