"""Observability layer: cross-layer schedule tracing, deadline
metrics, Perfetto export and trace-level differential diagnosis.

- `TraceRecorder` / `TraceEvent` — one zero-overhead-when-disabled
  event API shared by the DES, the serving runtime and the gateway
  (`repro_torch.obs.trace`).
- `MetricsRegistry` (+ `percentile`) — the deadline-compliance metrics
  catalog rolled up from a trace (`repro_torch.obs.metrics`).
- `to_chrome_trace` / `write_chrome_trace` — Chrome-trace-event JSON,
  loadable in Perfetto / chrome://tracing.
- `trace_diff` — first-divergence diagnosis between two layers' event
  streams (`repro_torch.obs.diff`), wired into the conformance harness.
- `SpanRecorder` / `Span` / `SpanTotals` (+ `SPAN_NAMES`) — timed spans
  inside the train step and prefill, on the host's clock and the card's,
  recorded while a `torch.profiler` session runs
  (`repro_torch.obs.spans`; the port's own, with no JAX counterpart;
  docs/repro_torch_spans.md).

See docs/observability.md for the event schema and metric catalog;
the vocabulary, metrics and diff are the JAX package's `repro.obs`,
string for string.
"""
from repro_torch.obs.diff import (
    DEFAULT_DIFF_KINDS,
    Divergence,
    TraceDiff,
    trace_diff,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    percentile,
    percentile_summary,
)
from repro_torch.obs.spans import (
    SPAN_NAMES,
    Span,
    SpanRecorder,
    SpanTotals,
)
from repro_torch.obs.trace import (
    EVENT_KINDS,
    LAYERS,
    TraceEvent,
    TraceRecorder,
    to_chrome_trace,
    write_chrome_trace,
)

__all__ = [
    "DEFAULT_DIFF_KINDS",
    "Divergence",
    "TraceDiff",
    "trace_diff",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "percentile",
    "percentile_summary",
    "SPAN_NAMES",
    "Span",
    "SpanRecorder",
    "SpanTotals",
    "EVENT_KINDS",
    "LAYERS",
    "TraceEvent",
    "TraceRecorder",
    "to_chrome_trace",
    "write_chrome_trace",
]
