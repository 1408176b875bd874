"""Telemetry of the port (the counterpart of ``repro/obs``): one registry,
one tracer and one attribution report for ``TrainRunner``, ``DataPipeline``,
``CheckpointManager`` and ``FoldEngine`` / ``ContinuousScheduler``.

* :mod:`.registry`: a metric registry (counters, gauges, histograms and
  named series, tagged by subsystem and bucket) with sinks
  (:mod:`.sinks`: in memory for tests, a JSONL file for runs, a periodic
  console line).  The subsystems report through it; ``TrainRunner.history``,
  ``FoldEngine.stats`` and ``CheckpointManager.stats`` stay as views of its
  contents or in step with its counters.
* :mod:`.tracing`: host spans (featurize, device_put, input_wait, step,
  eval, checkpoint in training; admit, recycle_step, harvest, fold_step in
  serving) exported as Chrome-trace / Perfetto JSON, and a
  ``torch.profiler`` window over the same step ids.
* :mod:`.attribution`: the measured step wall against
  ``analysis.roofline.predict_step_time`` for the active plan, model
  FLOP/s, MFU against the H100's peak, and goodput.
"""
from repro_torch.obs.attribution import attribution_report, describe_attribution
from repro_torch.obs.registry import Counter, Gauge, Histogram, MetricRegistry
from repro_torch.obs.sinks import ConsoleSink, JsonlSink, MemorySink
from repro_torch.obs.tracing import (ProfileWindow, SpanTracer, get_tracer,
                                     parse_profile_steps, set_tracer,
                                     trace_span)

__all__ = [
    "MetricRegistry", "Counter", "Gauge", "Histogram",
    "MemorySink", "JsonlSink", "ConsoleSink",
    "SpanTracer", "trace_span", "set_tracer", "get_tracer",
    "ProfileWindow", "parse_profile_steps",
    "attribution_report", "describe_attribution",
]
