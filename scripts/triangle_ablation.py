"""Ablations of the triangle-multiplicative kernels K3 and K5 on one GPU.

    python3 scripts/triangle_ablation.py

Each variant copies ``src/repro_torch/csrc`` to ``build/ablation/<name>``,
removes or changes one phase of one kernel there by a text substitution
(the script stops if a substitution no longer matches the sources),
compiles the copy with the flags of ``kernels/build.py`` and loads it in
place of the built library.  Each variant then runs K3 (the serving call:
incoming, r 256, c = c_z = 128, bf16) and K5 (the second operand side of
the same shapes) five times under ``torch.profiler`` and prints one line:
every kernel stage's device time per launch in microseconds.  A variant's
outputs are wrong by construction; only its times mean anything, as the
cost of the phase it takes away.  The first line is the unchanged sources.
"""
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import triangle as kt  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "ablation"
LIBS = ("triangle_mult_fwd", "triangle_mult_bwd")


def _between(path, start, end):
    text = (CSRC / path).read_text()
    a = text.index(start)
    return text[a:text.index(end, a)]


# keeps every accumulator live, so that removing the epilogue removes no
# product
KEEP = """      float sum = 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum += acc[mt][nt][e];
      if (sum == 12345.f) static_cast<float*>(s.out0)[threadIdx.x] = sum;
    }
"""
TILE = "constexpr int BM = 128, BN = 64, BK = 32, STAGES = 3, THREADS = 256;"


def variants():
    proj_epi = _between("tile_mma.cuh", "      // every load before the first store",
                        "    __syncthreads();  // the next iteration copies")
    out_ln = _between("triangle_mult_fwd.cu", "    // LayerNorm statistics over channels",
                      "    if (wn * 64 < cz) {")
    return {
        "unchanged": [],
        "proj_no_epilogue": [(proj_epi, KEEP)],
        "proj_no_x_loads": [(
            "      cp16(d + r * ldx + z, ok ? xi + (i64)k * s.sk + z : s.x, ok);",
            "      if (tl < 0) cp16(d + r * ldx + z, ok ? xi + (i64)k * s.sk + z : s.x, ok);")],
        "proj_no_bias_loads": [(
            "          bv[nt][e] = __bfloat162float(s.bias[ch]);\n"
            "          bgt[nt][e] = __bfloat162float(s.bias[c + ch]);",
            "          bv[nt][e] = 0.01f * ch;\n          bgt[nt][e] = 0.02f * ch;")],
        "proj_half_channels": [(
            "    for (int grp = wn; grp < c / 16; grp += PROJ_THREADS / 64) {",
            "    for (int grp = wn; grp < c / 32; grp += PROJ_THREADS / 64) {")],
        "k5_contract_no_dh_stores": [
            ("    *reinterpret_cast<uint4*>(hi + r * ld + col) = h;\n"
             "    *reinterpret_cast<uint4*>(lo + r * ld + col) = l;",
             "    if (h.x == 12345u) *reinterpret_cast<uint4*>(hi + r * ld + col) = h;\n"
             "    if (l.x == 12345u) *reinterpret_cast<uint4*>(lo + r * ld + col) = l;")],
        "k3_out_no_layernorm": [(out_ln, "    __syncthreads();\n")],
        "k3_out_no_mma": [
            ("for (int kk = 0; kk < c; kk += 16) {\n        uint32_t a[4];",
             "for (int kk = 0; kk < 0; kk += 16) {\n        uint32_t a[4];"),
            ("for (int kk = 0; kk < cz; kk += 16) {\n        uint32_t a[4];",
             "for (int kk = 0; kk < 0; kk += 16) {\n        uint32_t a[4];")],
        "k3_out_no_s_loads": [(
            "      tile::cp16(sd + ch * SP + q, src + ch * OP + q, true);",
            "      if (i < 0) tile::cp16(sd + ch * SP + q, src + ch * OP + q, true);")],
        "ring_4_stages": [(TILE, TILE.replace("STAGES = 3", "STAGES = 4"))],
        "ring_2_stages": [(TILE, TILE.replace("STAGES = 3", "STAGES = 2"))],
        "k_step_64": [(TILE, TILE.replace("BK = 32", "BK = 64"))],
    }


def start_build(name, subs):
    """Copy the sources with ``subs`` applied and start one nvcc per
    library; returns {library: (path, process)}."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    texts = {f.name: f.read_text() for f in CSRC.iterdir()}
    for old, new in subs:
        hits = [n for n, t in texts.items() if old in t]
        if not hits:
            raise SystemExit(f"{name}: substitution no longer matches the sources:\n{old}")
        for n in hits:
            texts[n] = texts[n].replace(old, new)
    for n, t in texts.items():
        (d / n).write_text(t)
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    return {lib: (d / f"{lib}.so", subprocess.Popen(
        [build.nvcc_path(), *flags, "-o", str(d / f"{lib}.so"), str(d / f"{lib}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for lib in LIBS}


def stage_times(dev):
    """Device microseconds per launch of each kernel of one K3 and one K5
    call, from five calls of each under the profiler."""
    g = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s, sc=1.0: (sc * torch.randn(s, device=dev, generator=g)).to(torch.bfloat16)
    r, c, cz = 256, 128, 128
    x = rn(r, r, cz)
    xab = x.transpose(0, 1)
    w = (rn(cz, 2 * c, sc=cz ** -0.5), rn(2 * c, sc=0.5), rn(cz, 2 * c, sc=cz ** -0.5),
         rn(2 * c, sc=0.5), 1 + rn(c, sc=0.1), rn(c, sc=0.1), rn(c, cz, sc=c ** -0.5),
         rn(cz, sc=0.1), rn(cz, cz, sc=cz ** -0.5), rn(cz, sc=0.5))
    ds = 1e-2 * torch.randn((r, r, c), device=dev, generator=g)
    k3 = lambda: kt.triangle_mult_fwd(xab, xab, x, *w)
    k5 = lambda: kt.triangle_mult_bwd_dx(ds.transpose(0, 1), xab, xab, w[2], w[3], w[0], w[1])
    for _ in range(3):
        k3(), k5()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            k3(), k5()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        m = re.search(r"(tri_\w+_kernel)", e.key)
        if m and e.self_device_time_total > 0:
            times[m.group(1)] = e.self_device_time_total / e.count
    return times


def main():
    if not torch.cuda.is_available():
        raise SystemExit("triangle_ablation.py: no CUDA device visible")
    dev = torch.device("cuda")
    pending = {name: start_build(name, subs) for name, subs in variants().items()}
    for name, libs in pending.items():
        for lib, (path, proc) in libs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"{name}: nvcc failed for {lib}:\n{log[-4000:]}")
            build._libs[lib] = ctypes.CDLL(str(path))
        times = stage_times(dev)
        print(f"[ablation] {name:26s} " + " ".join(
            f"{k}={v:.1f}" for k, v in sorted(times.items(), key=lambda kv: -kv[1])), flush=True)


if __name__ == "__main__":
    main()
