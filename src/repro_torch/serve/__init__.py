"""repro_torch.serve — the micro-batching serving substrate (copied from
``repro.serve``; numpy and the standard library only).

  sched     — event-driven micro-batch scheduler (injectable clock,
              per-lane SLO deadlines with EDF batch formation and
              expiry shedding, deadline/size flush, priority lanes,
              typed backpressure);
  aggregate — bitplane request aggregation: 32 concurrent requests per
              32-bit lane through one ``repro_torch.synth`` netlist eval;
  metrics   — enqueue→complete latency histograms, per-lane
              deadline-miss rates, shed counts, queue depth, batch
              occupancy and QPS;
  clock     — SystemClock / FakeClock so the whole engine is
              deterministic under test.

Replica dispatch (``repro.serve.replica``) is still to port.
"""
from .aggregate import BitplaneAggregator
from .clock import FakeClock, SystemClock
from .metrics import LatencyHistogram, ServeMetrics
from .sched import (BoundedPriorityQueue, MicroBatchScheduler, RejectReason,
                    RequestRejected, SchedConfig, ServeFuture, ServeRequest)

__all__ = [
    "BitplaneAggregator", "FakeClock", "SystemClock", "LatencyHistogram",
    "ServeMetrics", "BoundedPriorityQueue", "MicroBatchScheduler",
    "RejectReason", "RequestRejected", "SchedConfig", "ServeFuture",
    "ServeRequest",
]
