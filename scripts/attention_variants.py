#!/usr/bin/env python3
"""Variants of the attention kernels K6 and K2 on one GPU.

    python3 scripts/attention_variants.py [--only k6|k2] [NAME ...]

Each variant copies ``src/repro_torch/csrc`` to ``build/variants/<name>``,
changes one constant of a kernel there by a text substitution (the script
stops if a substitution no longer matches the sources), compiles the copy
with the flags of ``kernels/build.py`` (all variants in parallel) and loads
it in place of the built library.  Each variant then runs
``scripts/attention_bench.py``'s K6 and / or K2 timings, checks included,
and prints their path totals.  The first variant is the unchanged sources.
An ``ablate_`` variant removes one phase of a kernel: its outputs are wrong
by construction and not checked, and its per-kernel device times (printed
with the profile) are the cost of the phase it takes away.
"""
import argparse
import collections
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))
import attention_bench as ab  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "variants"
BWD = "evo_attention_bwd.cu"
FWD = "flash_attention_fwd.cu"
BUDGET = "constexpr int SMEM_BUDGET = 114688;"

ONE = (BWD, BUDGET, "constexpr int SMEM_BUDGET = 232448 - 1024;")
# ablations (outputs wrong by construction, only their times mean anything)
DQ_NO_LOADS = (BWD, "        load_rows<CP, 256>(d, k, l, (kt0 + j) * RT, h, S, H, C);\n"
               "        load_rows<CP, 256>(d + TILE, v, l, (kt0 + j) * RT, h, S, H, C);",
               "        if (i < 0) load_rows<CP, 256>(d, k, l, (kt0 + j) * RT, h, S, H, C);\n"
               "        if (i < 0) load_rows<CP, 256>(d + TILE, v, l, (kt0 + j) * RT, h, S, H, C);")
DQ_NO_SOFTMAX = (BWD, "          float ds = ex2(x) * (dp[nt][e] - (hi ? del1 : del0));",
                 "          float ds = x * dp[nt][e];")
DQ_NO_SCORES = (BWD, "      for (int kc = 0; kc < CP / 16; ++kc) {\n        uint32_t qa[4], da[4];",
                "      for (int kc = 0; kc < (S < 0 ? CP / 16 : 0); ++kc) {\n"
                "        uint32_t qa[4], da[4];")
DQ_NO_DQ_MMA = (BWD, "      for (int kc = 0; kc < RT / 16; ++kc) {\n        const uint32_t a[4]",
                "      for (int kc = 0; kc < (S < 0 ? RT / 16 : 0); ++kc) {\n"
                "        const uint32_t a[4]")
DKV_NO_LOADS = (BWD, "      load_rows<CP>(qs, q, l0 + li, qt * RT, h, S, H, C);\n"
                "      load_rows<CP>(qs + TILE, dor, l0 + li, qt * RT, h, S, H, C);",
                "      if (i < 0) load_rows<CP>(qs, q, l0 + li, qt * RT, h, S, H, C);\n"
                "      if (i < 0) load_rows<CP>(qs + TILE, dor, l0 + li, qt * RT, h, S, H, C);")
DKV_NO_SOFTMAX = (BWD, "        float p = ex2(x);\n        float ds = p * (dpt[nt][e] - del_s[lq]);",
                  "        float p = x;\n        float ds = x * dpt[nt][e];")
DKV_NO_ACC = (BWD, "        dka[f][e] = qt == 0 ? 0.f : akp[(f * 4 + e) * 32];\n"
              "        dva[f][e] = qt == 0 ? 0.f : avp[(f * 4 + e) * 32];",
              "        dka[f][e] = 0.f;\n        dva[f][e] = 0.f;")
K6_NO_PINGPONG = (FWD, "constexpr bool PINGPONG = true;", "constexpr bool PINGPONG = false;")
K6_BN64 = [(FWD, "constexpr int BN = 128; ", "constexpr int BN = 64; "),
           (FWD, "constexpr int STAGES = 3;", "constexpr int STAGES = 4;")]
K6_STAGES2 = (FWD, "constexpr int STAGES = 3;", "constexpr int STAGES = 2;")
K6_NO_SOFTMAX = (FWD, ("  float mx[2] = {m[0], m[1]};\n#pragma unroll\n  for (int j = 0; j < w::BN / 8; ++j) {",
                       "  l[0] = l[0] * corr[0] + ps[0];"),
                 "  float ps[2] = {sc[0], sc[1]};\n  corr[0] = corr[1] = 1.f;\n")
K6_NO_PV = (FWD, "    wg::wgmma_m64n128k16_rs_tb(o, pa[kk], wg::desc_sw128(vb + kk * 16 * 128, "
            "w::PANEL_KV, 1024));",
            "    if (vb == 0xffffffffu) wg::wgmma_m64n128k16_rs_tb(o, pa[kk], "
            "wg::desc_sw128(vb + kk * 16 * 128, w::PANEL_KV, 1024));")

# name -> [(file, old, new)]; old may be (start, end): the text between
VARIANTS = {
    "unchanged": [],
    "k6_bn64": K6_BN64,
    "k6_stages2": [K6_STAGES2],
    "k6_no_pingpong": [K6_NO_PINGPONG],
    "k2_one_block": [ONE],
    "ablate_k6_no_softmax": [K6_NO_SOFTMAX],
    "ablate_k6_no_pv": [K6_NO_PV],
    "ablate_dq_no_loads": [DQ_NO_LOADS],
    "ablate_dq_no_softmax": [DQ_NO_SOFTMAX],
    "ablate_dq_no_scores": [DQ_NO_SCORES],
    "ablate_dq_no_dq_mma": [DQ_NO_DQ_MMA],
    "ablate_dkv_no_loads": [DKV_NO_LOADS],
    "ablate_dkv_no_softmax": [DKV_NO_SOFTMAX],
    "ablate_dkv_no_acc": [DKV_NO_ACC],
}

def prepare(name, subs):
    d = OUT / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(CSRC, d)
    for fname, old, new in subs:
        text = (d / fname).read_text()
        if isinstance(old, tuple):  # (start, end): replace the text between
            a, b = text.find(old[0]), text.find(old[1])
            if a < 0 or b < a:
                raise SystemExit(f"variant {name}: markers no longer match {fname}:\n{old}")
            (d / fname).write_text(text[:a] + new + text[b:])
            continue
        if old not in text:
            raise SystemExit(f"variant {name}: substitution no longer matches {fname}:\n{old}")
        (d / fname).write_text(text.replace(old, new))
    procs = {}
    for lib in ("flash_attention_fwd", "evo_attention_bwd"):
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / f"{lib}.so"),
               str(d / f"{lib}.cu")]
        procs[lib] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    return procs


def sass_mix(name, so, keep=("wgmma", "_win_", "_ring_", "prep_bf16")):
    """Static instruction count of each bf16 kernel in ``so`` and its most
    frequent opcodes (cuobjdump -sass)."""
    cuobjdump = pathlib.Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    for block in re.split(r"\n\s+Function : ", sass)[1:]:
        fn = block.split("\n", 1)[0]
        if not any(k in fn for k in keep):
            continue
        ops = collections.Counter(
            m.split(".")[0] for m in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", block))
        print(f"[variant {name} sass] {build._kernel_name(fn)} {fn[-30:]}: "
              f"{sum(ops.values())} instructions, {dict(ops.most_common(12))}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("k6", "k2"))
    ap.add_argument("--sass", action="store_true",
                    help="print each variant's instruction mix per kernel (cuobjdump)")
    ap.add_argument("names", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_variants.py: no CUDA device visible")
    names = args.names or list(VARIANTS)
    pending = {n: prepare(n, VARIANTS[n]) for n in names}
    dev = torch.device("cuda")
    print(f"[device] {ab.cs.device_line()}", flush=True)
    for n, procs in pending.items():
        for lib, p in procs.items():
            log, _ = p.communicate()
            if p.returncode != 0:
                raise SystemExit(f"variant {n}: nvcc failed for {lib}:\n{log[-4000:]}")
            for line in build.ptxas_summary(log).splitlines():
                if "_ring_" in line or "wgmma" in line:
                    print(f"[variant {n} build] {lib}: {line}")
    for n in names:
        if args.sass:
            for lib in ("flash_attention_fwd", "evo_attention_bwd"):
                sass_mix(n, OUT / n / f"{lib}.so")
        for lib in ("flash_attention_fwd", "evo_attention_bwd"):
            build._libs[lib] = ctypes.CDLL(str(OUT / n / f"{lib}.so"))
        print(f"[variant] {n}", flush=True)
        check = not n.startswith("ablate")
        ab.PROFILE = True
        if args.only in (None, "k6"):
            ab.bench_k6(dev, 3, check)
        if args.only in (None, "k2"):
            ab.bench_k2(dev, 3, check)
    return 0


if __name__ == "__main__":
    sys.exit(main())
