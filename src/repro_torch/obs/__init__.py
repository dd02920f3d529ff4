"""repro_torch.obs — the measurement substrate for the port's serving
stack (copied from ``repro.obs``; ``kernelprof`` times the CUDA
``lut_eval`` walks with CUDA events, everything else is numpy and the
standard library).

  trace      — thread-safe ring-buffer span tracer (injectable clock,
               near-zero overhead when disabled); every request carries
               submit → queue-wait → batch-formation (with flush
               reason) → pack → dispatch → device-exec → scatter spans;
  export     — Chrome trace-event JSON (opens in Perfetto / chrome://
               tracing) and structured JSONL event export;
  registry   — one counters/gauges/histograms registry that
               ``ServeMetrics``, ``ReplicaSet`` and
               ``BitplaneAggregator`` publish into, with a single
               ``snapshot()`` surface;
  kernelprof — per-level ``lut_eval`` device timing (both walks) fitted
               into a measured ``(level_width, k, fanin) -> µs`` table,
               written as an artifact that names the device it was
               measured on, so ``least_slack`` dispatch and the flush
               margin consume calibrated estimates instead of a
               cold-start EWMA;
  analyze    — trace artifacts back into per-request phase breakdowns
               ("where did the time go"), reconciliation against the
               scheduler-stamped latency, and trace-vs-trace diffing
               (``python -m repro_torch.obs.analyze --trace ...``);
  window     — streaming tumbling/sliding-window aggregation: per-lane
               QPS / p50 / p99 / SLO-attainment *time series* instead
               of one end-of-run snapshot;
  slo        — multi-window SLO burn-rate monitor with alert callbacks,
               the scheduler's optional degradation hook;
  online     — sampled real-traffic timings blended back into the
               ``LatencyTable`` so flush margins track the live device;
  promexport — Prometheus text-exposition rendering of a registry
               snapshot plus a stdlib pull endpoint
               (``launch.serve --metrics-port``).

``repro_torch.bench.loadgen`` and ``repro_torch.launch.serve --trace
PATH`` wire the tracer through the whole request path.
"""
from .trace import (FLUSH_REASONS, NULL_TRACER, NullTracer, SpanTracer,
                    TraceEvent)
from .export import (load_trace_events, to_chrome_trace, to_jsonl,
                     write_chrome_trace, write_jsonl)
from .registry import Counter, Gauge, MetricsRegistry
from .kernelprof import (EmptyLatencyTable, LatencyTable,
                         LatencyTableError, measure_level_grid,
                         profile_plan, build_latency_table)
from .analyze import TraceReport, analyze_events, analyze_trace
from .window import BucketRing, WindowedMetrics
from .slo import BurnAlert, BurnRateMonitor
from .online import OnlineProfiler
from .promexport import MetricsServer, to_prometheus_text

__all__ = [
    "FLUSH_REASONS", "NULL_TRACER", "NullTracer", "SpanTracer",
    "TraceEvent",
    "load_trace_events", "to_chrome_trace", "to_jsonl",
    "write_chrome_trace", "write_jsonl",
    "Counter", "Gauge", "MetricsRegistry",
    "EmptyLatencyTable", "LatencyTable", "LatencyTableError",
    "measure_level_grid", "profile_plan", "build_latency_table",
    "TraceReport", "analyze_events", "analyze_trace",
    "BucketRing", "WindowedMetrics",
    "BurnAlert", "BurnRateMonitor",
    "OnlineProfiler",
    "MetricsServer", "to_prometheus_text",
]
