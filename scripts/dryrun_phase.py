#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 13 alone on one NVIDIA GPU: the dry run
(``repro_torch.launch.dryrun``) held to the card.  (a) af2_initial's
training step (batch 1, one recycle, remat block, K1-K5) and (b)
whisper-medium's (2 x 448 tokens, remat layer, K6) are measured on the card
and dry-run on ``meta``: each predicted peak within 10 % of
``max_memory_allocated``; (c) each kernel's meta route against the kernel;
(d) an af2_tiny cell on a 2x4 virtual mesh.  It prints the phase's lines
and wall.

    python3 scripts/dryrun_phase.py

About 2 minutes with the kernels' build.
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
        raise SystemExit("dryrun_phase.py: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    card = cs.device_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    print(f"[build] {build.build_all():.1f} s", flush=True)
    out = cs.dryrun_phase(torch.device("cuda"), card)
    print(f"phase 13 {out['wall_s']:.1f} s; in all "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
