#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 14 alone on one NVIDIA GPU: tensor
parallelism over 'model' on four gloo ranks sharing the card.  Phase 11's
part it needs comes first (glm4-9b at full size through ``DecodeEngine``
on one device, eagerly, its logits held to the plain path), then phase 13's
prediction of (c)'s peak, then (a)-(d).  It prints the phase's lines and
wall.

    python3 scripts/tp_phase.py

About 5 minutes with the kernels' build.
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
        raise SystemExit("tp_phase.py: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    card = cs.device_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    print(f"[build] {build.build_all():.1f} s", flush=True)
    dev = torch.device("cuda")
    cfg, params, _ = cs.lm_params(dev)
    refs = {}
    engine, rec, reqs, done, counts, *_ = cs.lm_main_path(cfg, params, dev,
                                                          graphs=False)
    cs.check_lm_main_path(cfg, engine, rec, reqs, done, counts, refs)
    rec.restore()
    del engine, rec, params
    torch.cuda.empty_cache()
    print(f"[time] phase 11's eager run at {time.perf_counter() - t0:.1f} s",
          flush=True)
    dry = cs.dryrun_tp_train()
    out = cs.tp_phase(dev, card, {"reqs": reqs, "tokens": done,
                                  "refs": refs}, dry)
    print(f"phase 14 {out['wall_s']:.1f} s; in all "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
