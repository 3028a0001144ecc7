"""Telemetry layer: spans, metrics, kernel-time calibration.

Counterpart of `repro.obs`, with its public names.

  Switch      enabled() / enable() / disable() / recording() -- one global
              flag; every instrumented call site costs a bool read when off.
  Record      span(name, **attrs) context manager (nestable, exception-
              safe), maybe_span(name, *guard_tensors, **attrs) (no-op
              where the reference is traced: inside `traced()` or on a
              tensor that requires grad), inc / gauge / observe, Recorder,
              Histogram.
  Export      write_jsonl / load_jsonl, prometheus_text, summary_table,
              merged_chrome_trace (engine spans + scheduler tasks in one
              Perfetto view).
  Calibrate   measure_kernel_times / calibrate -- persist measured
              per-(kind, tier) task times for the scheduler's cost model
              (`launch.costmodel.task_virtual_cost(..., calibrated=True)`).

Where a span's caller has a result on the card, it synchronizes the device
before the span closes, and only when the span is live: a disabled run
never synchronizes.

CLI: `python -m repro_torch.obs calibrate` and `python -m repro_torch.obs
demo-trace`.
"""

from .calibrate import calibrate, cost_key, measure_kernel_times, write_calibration
from .export import (
    events,
    load_jsonl,
    merged_chrome_trace,
    prometheus_text,
    summary_from_events,
    summary_rows,
    summary_table,
    write_jsonl,
    write_merged_trace,
)
from .recorder import (
    DEFAULT_BUCKETS,
    Histogram,
    NULL_SPAN,
    Recorder,
    SpanRecord,
    disable,
    enable,
    enabled,
    gauge,
    get_recorder,
    inc,
    maybe_span,
    observe,
    recording,
    span,
    traced,
)

__all__ = [
    "DEFAULT_BUCKETS", "Histogram", "NULL_SPAN", "Recorder", "SpanRecord",
    "calibrate", "cost_key", "disable", "enable", "enabled", "events",
    "gauge", "get_recorder", "inc", "load_jsonl", "maybe_span",
    "measure_kernel_times", "merged_chrome_trace", "observe",
    "prometheus_text", "recording", "span", "summary_from_events",
    "summary_rows", "summary_table", "write_calibration", "write_jsonl",
    "write_merged_trace",
]
