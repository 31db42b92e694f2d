"""The port's measurement layer (counterpart of ``alpa_tpu/telemetry``).

* ``trace`` -- thread-safe span tracing with Chrome-trace (Perfetto)
  export; free when off.
* ``metrics`` -- the process registry of Counter / Gauge / Histogram
  families with Prometheus text exposition (the serving controller's
  ``GET /metrics``).
* ``flight`` -- the flight recorder: a fixed ring of the last replayed
  ops, dumped when a pipeshard step raises.
* ``perf`` -- the step's performance report (critical path, bubbles,
  stage MFU) and the one peak / MFU formula (``GPU_SPECS``).
* ``calibration`` -- the store of measured costs and the model's drift.

Knobs: ``global_config.telemetry_*``, ``collect_trace``,
``flight_recorder*``, ``device_peak_tflops`` (``ALPA_TPU_TRACE``,
``ALPA_TPU_TRACE_DIR``, ``ALPA_TPU_FLIGHT``, ...).
"""
from alpa_tpu_torch.telemetry.metrics import (       # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, DEFAULT_BUCKETS,
    get_registry, reset_registry)
from alpa_tpu_torch.telemetry.trace import (         # noqa: F401
    CATEGORIES, TraceRecorder, begin, counter, enabled, end,
    get_recorder, instant, merge_chrome_traces, set_enabled,
    set_recorder, span)
from alpa_tpu_torch.telemetry.flight import FlightRecorder  # noqa: F401
from alpa_tpu_torch.telemetry.perf import (          # noqa: F401
    StepPerfReport, build_step_report, compute_mfu, device_peak_tflops,
    mfu_from_time, report_from_trace, stage_flops)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_BUCKETS", "get_registry", "reset_registry",
    "CATEGORIES", "TraceRecorder", "begin", "counter", "enabled",
    "end", "get_recorder", "instant", "merge_chrome_traces",
    "set_enabled", "set_recorder", "span", "FlightRecorder",
    "StepPerfReport", "build_step_report", "compute_mfu",
    "device_peak_tflops", "mfu_from_time", "report_from_trace",
    "stage_flops",
]
