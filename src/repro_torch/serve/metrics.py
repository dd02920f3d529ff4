"""Serving metrics: latency histograms, queue depth, occupancy, QPS.

``ServeMetrics`` is the one object every scheduler/engine records into;
``snapshot()`` is the one dict every benchmark and launcher reports.
Latencies are enqueue→complete (the number a client actually sees),
never bare execution time — hiding head-of-line queueing is exactly the
bug the legacy ``serve_queue`` stats had.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional

import numpy as np

# log-spaced histogram bucket edges: 0.1 µs .. ~100 s, 10 buckets/decade
_BUCKET_LO_US = 0.1
_BUCKETS_PER_DECADE = 10
_N_BUCKETS = 9 * _BUCKETS_PER_DECADE + 1


def _bucket_of(us: float) -> int:
    if us <= _BUCKET_LO_US:
        return 0
    b = int(math.log10(us / _BUCKET_LO_US) * _BUCKETS_PER_DECADE)
    return min(b, _N_BUCKETS - 1)


class LatencyHistogram:
    """Log-bucketed latency histogram with exact-sample percentiles.

    Bucket counts give a bounded-memory view for dashboards; raw samples
    (bounded reservoir) keep p50/p95/p99 exact at benchmark scale.
    """

    def __init__(self, max_samples: int = 200_000):
        self.counts = np.zeros(_N_BUCKETS, np.int64)
        self.samples: List[float] = []
        # <= 0 means counts-only (no reservoir, percentiles report 0.0)
        # rather than a ZeroDivisionError on the first overflow write
        self.max_samples = max(int(max_samples), 0)
        self.n = 0
        self.total_us = 0.0

    def record(self, us: float) -> None:
        self.counts[_bucket_of(us)] += 1
        self.n += 1
        self.total_us += us
        if self.max_samples <= 0:
            return
        if len(self.samples) < self.max_samples:
            self.samples.append(us)
        else:  # reservoir: deterministic stride keep (no RNG in hot path)
            i = self.n % self.max_samples
            self.samples[i] = us

    def percentile(self, p: float) -> float:
        """Exact sample percentile; ``p`` is clamped to [0, 100] (p0 =
        min, p100 = max) and an empty reservoir reports 0.0."""
        if not self.samples:
            return 0.0
        p = min(max(float(p), 0.0), 100.0)
        return float(np.percentile(np.asarray(self.samples), p))

    def mean(self) -> float:
        return self.total_us / self.n if self.n else 0.0

    def buckets(self) -> Dict[str, int]:
        """Non-empty buckets keyed by their lower edge (µs)."""
        out = {}
        for b in np.nonzero(self.counts)[0]:
            lo = _BUCKET_LO_US * 10 ** (b / _BUCKETS_PER_DECADE)
            out[f"{lo:.3g}us"] = int(self.counts[b])
        return out


@dataclasses.dataclass
class BatchStat:
    rows: int
    occupancy: float
    exec_us: float


class LaneStats:
    """Per-priority-lane deadline accounting.

    A lane's deadline-miss rate counts both kinds of SLO failure:
    requests *shed* before dispatch (expired in queue) and requests
    *served late* (completed past their deadline). The denominator is
    deadline-carrying traffic only, and a lane that carried none omits
    ``deadline_miss_rate`` / ``slo_attainment`` from its snapshot
    entirely — a fake perfect score would otherwise seed benchmark
    baselines with a metric that was never measured.
    """

    def __init__(self):
        self.completed = 0              # all completions on this lane
        self.with_deadline = 0          # completions that carried an SLO
        self.missed = 0                 # completed but past deadline
        self.shed = 0                   # expired before dispatch
        self.lat = LatencyHistogram()
        self.slack = LatencyHistogram()     # positive slack at completion
        self.slack_sum_us = 0.0             # signed, over with_deadline

    def snapshot(self) -> Dict[str, float]:
        slo_n = self.with_deadline + self.shed
        out = {
            "completed": self.completed,
            "completed_with_deadline": self.with_deadline,
            "missed": self.missed,
            "shed": self.shed,
            "p50_us": self.lat.percentile(50),
            "p95_us": self.lat.percentile(95),
            "p99_us": self.lat.percentile(99),
            "slack_p50_us": self.slack.percentile(50),
            "slack_p10_us": self.slack.percentile(10),
            "mean_slack_us": (self.slack_sum_us / self.with_deadline
                              if self.with_deadline else 0.0),
            "slack_buckets": self.slack.buckets(),
        }
        if slo_n:        # only lanes that carried deadlines get a rate:
            # a deadline-free lane reporting attainment 1.0 would seed
            # regression baselines with a score that was never measured
            miss = (self.missed + self.shed) / slo_n
            out["deadline_miss_rate"] = miss
            out["slo_attainment"] = 1.0 - miss
        return out


class ServeMetrics:
    """Thread-safe accumulator for one scheduler (or engine) lifetime.

    Beyond accumulating, it fans events out to registered **sinks**
    (``add_sink``): streaming aggregators like
    ``repro.obs.window.WindowedMetrics`` and the burn-rate monitor in
    ``repro.obs.slo`` receive ``record_done(lane, latency_us, now_us,
    ok, rows, deadline_us)`` / ``record_shed(lane, now_us)`` /
    ``record_batch(rows, exec_us, now_us, occupancy)`` pushes with the
    scheduler-clock timestamp. Forwarding happens *outside* this
    object's lock — sinks take their own locks, and a sink must never
    call back into the scheduler (the scheduler records while holding
    its own state)."""

    def __init__(self, max_batch: int = 0):
        self._sinks: List = []
        self.max_batch = max_batch
        self.lat = LatencyHistogram()
        self.batches: List[BatchStat] = []
        self.completed = 0
        self.rejected: Dict[str, int] = {}
        self.errors = 0
        self.lanes: Dict[int, LaneStats] = {}
        self.queue_depth_sum = 0
        self.queue_depth_n = 0
        self.max_queue_depth = 0
        self.t_first_enqueue_us: Optional[float] = None
        self.t_last_done_us: Optional[float] = None
        self._lock = threading.Lock()

    def _lane(self, lane: int) -> LaneStats:
        if lane not in self.lanes:
            self.lanes[lane] = LaneStats()
        return self.lanes[lane]

    def add_sink(self, sink) -> "ServeMetrics":
        """Register a streaming consumer of recorded events. The sink
        may implement any subset of ``record_done`` / ``record_shed`` /
        ``record_batch`` (missing methods are skipped)."""
        self._sinks.append(sink)
        return self

    def _fan_out(self, method: str, /, **kw) -> None:
        for s in self._sinks:
            fn = getattr(s, method, None)
            if fn is not None:
                fn(**kw)

    # -- recording ---------------------------------------------------------
    def record_enqueue(self, depth: int, now_us: float) -> None:
        with self._lock:
            self.queue_depth_sum += depth
            self.queue_depth_n += 1
            self.max_queue_depth = max(self.max_queue_depth, depth)
            if self.t_first_enqueue_us is None:
                self.t_first_enqueue_us = now_us

    def record_reject(self, reason: str) -> None:
        with self._lock:
            self.rejected[reason] = self.rejected.get(reason, 0) + 1

    def record_batch(self, rows: int, exec_us: float,
                     now_us: Optional[float] = None) -> None:
        occ = rows / self.max_batch if self.max_batch else 1.0
        with self._lock:
            self.batches.append(BatchStat(rows, occ, exec_us))
        if self._sinks and now_us is not None:
            self._fan_out("record_batch", rows=rows, exec_us=exec_us,
                          now_us=now_us, occupancy=occ)

    def record_done(self, latency_us: float, now_us: float, lane: int = 0,
                    deadline_us: float = math.inf) -> None:
        with self._lock:
            self.lat.record(latency_us)
            self.completed += 1
            self.t_last_done_us = now_us
            ls = self._lane(lane)
            ls.completed += 1
            ls.lat.record(latency_us)
            has_deadline = math.isfinite(deadline_us)
            ok = True
            if has_deadline:
                slack = deadline_us - now_us
                ls.with_deadline += 1
                ls.slack_sum_us += slack
                if slack >= 0:
                    ls.slack.record(slack)
                else:
                    ls.missed += 1      # served, but past its deadline
                    ok = False
        if self._sinks:
            self._fan_out("record_done", lane=lane, latency_us=latency_us,
                          now_us=now_us, ok=ok,
                          deadline_us=(deadline_us if has_deadline
                                       else None))

    def record_shed(self, lane: int = 0,
                    now_us: Optional[float] = None) -> None:
        """An expired request rejected before dispatch (SLO shed)."""
        with self._lock:
            self._lane(lane).shed += 1
            self.rejected["deadline_exceeded"] = (
                self.rejected.get("deadline_exceeded", 0) + 1)
        if self._sinks and now_us is not None:
            self._fan_out("record_shed", lane=lane, now_us=now_us)

    def record_error(self, n_requests: int = 1) -> None:
        with self._lock:
            self.errors += n_requests

    # -- reporting ---------------------------------------------------------
    def publish(self, registry, name: str = "serve") -> None:
        """Expose this accumulator through a
        ``repro.obs.MetricsRegistry``: ``registry.snapshot()[name]`` is
        this object's ``snapshot()``, evaluated lazily."""
        registry.register(name, self.snapshot)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            span_us = 0.0
            if (self.t_first_enqueue_us is not None
                    and self.t_last_done_us is not None):
                span_us = self.t_last_done_us - self.t_first_enqueue_us
            occ = [b.occupancy for b in self.batches]
            rows = [b.rows for b in self.batches]
            shed = sum(ls.shed for ls in self.lanes.values())
            missed = sum(ls.missed for ls in self.lanes.values())
            slo_n = shed + sum(ls.with_deadline
                               for ls in self.lanes.values())
            return {
                "completed": self.completed,
                "rejected": int(sum(self.rejected.values())),
                "rejected_by_reason": dict(self.rejected),
                "errors": self.errors,
                "shed": shed,
                "deadline_missed": missed,
                "deadline_miss_rate": ((missed + shed) / slo_n
                                       if slo_n else 0.0),
                "lanes": {str(k): ls.snapshot()
                          for k, ls in sorted(self.lanes.items())},
                "p50_us": self.lat.percentile(50),
                "p95_us": self.lat.percentile(95),
                "p99_us": self.lat.percentile(99),
                "mean_us": self.lat.mean(),
                "qps": (self.completed / (span_us * 1e-6)
                        if span_us > 0 else 0.0),
                "span_us": span_us,
                "n_batches": len(self.batches),
                "mean_batch_rows": float(np.mean(rows)) if rows else 0.0,
                "mean_batch_occupancy": float(np.mean(occ)) if occ else 0.0,
                "mean_queue_depth": (self.queue_depth_sum
                                     / self.queue_depth_n
                                     if self.queue_depth_n else 0.0),
                "max_queue_depth": self.max_queue_depth,
                "latency_buckets": self.lat.buckets(),
            }
