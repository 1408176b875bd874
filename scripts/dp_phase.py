#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 11d alone on one NVIDIA GPU: an
af2_initial fold at the configs' own impls against ``with_kernels`` and
af2_tiny at those impls on the card against the CPU; whisper-medium
trained at full width and depth by the train launcher's ``run_lm`` over
two gloo ranks sharing the card (FSDP over 'data'), held to one device;
the launcher's six LM families at ``--smoke`` on two ranks against one
device (the one-device runs made here, as phase 11c (e) makes them in
``chip_smoke.py``); ``bp_parallel_layer`` against ``layer_apply``.  Every
check of the phase applies; it prints the phase's lines and wall.

    python3 scripts/dp_phase.py

About 3 minutes with the kernels' build.
"""
import contextlib
import io
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
        raise SystemExit("dp_phase.py: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.launch import train
    card = cs.device_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    print(f"[build] {build.build_all():.1f} s", flush=True)
    launcher = {}
    for arch in cs.LAUNCH_ARCHS:
        with contextlib.redirect_stdout(io.StringIO()):
            launcher[arch] = {"card": train.main(["--arch", arch,
                                                  *cs.LAUNCH_ARGS])}
    t1 = time.perf_counter()
    out = cs.dp_phase(torch.device("cuda"), card, launcher)
    print(f"phase 11d {out['wall_s']:.1f} s (the one-device launcher runs "
          f"{t1 - t0:.1f} s with the build); in all "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
