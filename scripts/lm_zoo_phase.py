#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 11c alone on one NVIDIA GPU: K6 at the
whisper-medium encoder, whisper training's cross-attention and the
internvl2-26b prefill shapes; whisper-medium and internvl2-26b served at
full width and depth, eagerly and as CUDA graphs; whisper-medium trained
at full width and depth; the train launcher's six LM families on the card
against the CPU.  Every check of the phase applies; it prints the phase's
lines and wall.

    python3 scripts/lm_zoo_phase.py

About 1.5 minutes with the kernels' build (``chip_smoke.py`` whole takes
~16).
"""
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("lm_zoo_phase.py: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    print(cs.device_line(), flush=True)
    t0 = time.perf_counter()
    print(f"[build] {build.build_all():.1f} s", flush=True)
    out = cs.av_phase(torch.device("cuda"))
    print(f"phase 11c {out['wall_s']:.1f} s, with the build "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
