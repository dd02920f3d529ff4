"""repro_torch.serve — the micro-batching serving substrate (copied from
``repro.serve``; numpy and the standard library only).

  sched     — event-driven micro-batch scheduler (injectable clock,
              per-lane SLO deadlines with EDF batch formation and
              expiry shedding, deadline/size flush, priority lanes,
              typed backpressure);
  aggregate — bitplane request aggregation: 32 concurrent requests per
              32-bit lane through one ``repro_torch.synth`` netlist eval;
  replica   — round-robin / least-loaded / least-slack dispatch with
              deadline-aware failover over data-parallel engine
              replicas on one device;
  metrics   — enqueue→complete latency histograms, per-lane
              deadline-miss rates, shed counts, queue depth, batch
              occupancy and QPS;
  clock     — SystemClock / FakeClock so the whole engine is
              deterministic under test.

``repro_torch.bench.loadgen`` drives the stack end to end (open loop,
closed loop, SLO lanes, replicas).
"""
from .aggregate import BitplaneAggregator
from .clock import FakeClock, SystemClock
from .metrics import LatencyHistogram, ServeMetrics
from .replica import AllReplicasDown, ReplicaSet, build_logic_replicas
from .sched import (BoundedPriorityQueue, MicroBatchScheduler, RejectReason,
                    RequestRejected, SchedConfig, ServeFuture, ServeRequest)

__all__ = [
    "BitplaneAggregator", "FakeClock", "SystemClock", "LatencyHistogram",
    "ServeMetrics", "AllReplicasDown", "ReplicaSet", "build_logic_replicas",
    "BoundedPriorityQueue", "MicroBatchScheduler",
    "RejectReason", "RequestRejected", "SchedConfig", "ServeFuture",
    "ServeRequest",
]
