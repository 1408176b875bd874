"""Roofline against measurement: does the plan deliver its prediction? (The
port's copy of ``repro/obs/attribution.py``.)

``attribution_report`` sets a measured step wall beside
``analysis.roofline.predict_step_time`` for the active ``ParallelPlan``:

* ``predicted_step_s`` and ``measured_step_s`` and their ratio (above 1:
  slower than the cost model that ranks plans);
* ``achieved_flops``: model FLOP/s sustained;
* ``mfu``: achieved / (n_devices x hw.peak_flops), the whole step's share
  of the cards' dense bf16 peak (the H100's 989 TFLOP/s by default);
* ``goodput``: the share of wall time that is neither input stall nor
  evaluation / checkpoint overhead.

Plain arithmetic over floats.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.analysis.roofline import HW, predict_step_time


def attribution_report(cfg, plan, *, global_batch: int,
                       n_recycle: float, measured_step_s: float,
                       stall_fraction: float = 0.0,
                       overhead_s: float = 0.0,
                       wall_s: Optional[float] = None,
                       hw: HW = HW(), elt: int = 2,
                       step: Optional[int] = None) -> dict:
    """One attribution row (a plain dict, JSON-ready).

    ``measured_step_s`` is the mean training-step wall over the window
    attributed; ``overhead_s`` / ``wall_s`` price evaluation and checkpoint
    time against the window's wall for goodput; ``stall_fraction`` is the
    input pipeline's stall share of that window.
    """
    pred = predict_step_time(
        cfg, bp=plan.branch, dap=plan.dap, pod=plan.pod, data=plan.data,
        global_batch=global_batch, n_recycle=n_recycle, hw=hw, elt=elt,
        overlap=getattr(plan, "overlap_dap", None))
    measured = float(measured_step_s)
    flops = pred["model_flops_per_step"]
    achieved = flops / measured if measured > 0 else 0.0
    n_dev = pred["n_devices"]
    mfu = achieved / (n_dev * hw.peak_flops) if n_dev > 0 else 0.0
    overhead_frac = (overhead_s / wall_s) if wall_s and wall_s > 0 else 0.0
    goodput = max(0.0, 1.0 - float(stall_fraction) - overhead_frac)
    return {
        "step": step,
        "measured_step_s": measured,
        "predicted_step_s": pred["predicted_step_s"],
        "measured_over_predicted": (
            measured / pred["predicted_step_s"]
            if pred["predicted_step_s"] > 0 else float("inf")),
        "model_flops_per_step": flops,
        "achieved_flops": achieved,
        "mfu": mfu,
        "goodput": goodput,
        "stall_fraction": float(stall_fraction),
        "overhead_fraction": overhead_frac,
        "n_devices": n_dev,
        "plan": plan.describe() if hasattr(plan, "describe") else str(plan),
        "global_batch": global_batch,
        "n_recycle": float(n_recycle),
    }


def describe_attribution(rep: dict) -> str:
    """One line for launcher logs."""
    return (f"attribution[step {rep.get('step')}]: "
            f"measured {rep['measured_step_s'] * 1e3:.1f} ms/step vs "
            f"predicted {rep['predicted_step_s'] * 1e3:.3f} ms "
            f"(x{rep['measured_over_predicted']:.1f}); "
            f"{rep['achieved_flops'] / 1e12:.4f} TFLOP/s achieved, "
            f"MFU {rep['mfu'] * 100:.3f}%, "
            f"goodput {rep['goodput'] * 100:.1f}%, "
            f"stall {rep['stall_fraction'] * 100:.1f}%")
