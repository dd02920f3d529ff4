"""Streaming windowed metrics: per-lane time series, not one snapshot.

``ServeMetrics.snapshot()`` answers "how did the whole run go";
nothing in the repo could answer "what is happening *right now*" — a
p99 that degraded in the last two seconds is invisible inside an
end-of-run histogram. This module keeps bounded **tumbling windows**
(fixed-width time buckets on a ring, old buckets evicted as time
advances) and derives **sliding-window** views by summing the most
recent buckets, the standard streaming-aggregation trade: O(1) memory
per window, O(windows) query cost, no per-event allocation beyond a
bounded latency reservoir.

Feeding is push-based: ``ServeMetrics.add_sink(WindowedMetrics(...))``
forwards every completion/shed/batch to the window aggregator with the
scheduler-clock timestamp, so FakeClock tests produce exact,
deterministic series. ``series()`` returns per-lane
``[{t_us, qps, p50_us, p99_us, slo_attainment, ...}]`` rows plus a
batch-occupancy track; ``sliding(span_us)`` merges the trailing span
into one record (what the SLO burn-rate monitor in ``repro_torch.obs.slo``
is built on).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

# per-bucket latency reservoir bound: enough for exact-ish tail
# percentiles at smoke-benchmark scale without per-event allocation
DEFAULT_BUCKET_SAMPLES = 512


class _Bucket:
    """One tumbling-window bucket of lane activity."""

    __slots__ = ("n_done", "n_ok", "n_miss", "n_shed", "rows",
                 "lat_sum_us", "samples", "_max_samples")

    def __init__(self, max_samples: int = DEFAULT_BUCKET_SAMPLES):
        self.n_done = 0         # completions landing in this bucket
        self.n_ok = 0           # completed within deadline (or no deadline)
        self.n_miss = 0         # completed past deadline
        self.n_shed = 0         # expired before dispatch
        self.rows = 0
        self.lat_sum_us = 0.0
        self.samples: List[float] = []
        self._max_samples = max_samples

    def add_done(self, latency_us: float, ok: bool, rows: int,
                 has_deadline: bool = True) -> None:
        self.n_done += 1
        self.rows += rows
        self.lat_sum_us += latency_us
        # only deadline-carrying traffic enters the attainment counters:
        # a best-effort completion is neither "within SLO" nor a miss
        if has_deadline:
            if ok:
                self.n_ok += 1
            else:
                self.n_miss += 1
        if len(self.samples) < self._max_samples:
            self.samples.append(latency_us)
        else:   # deterministic stride reservoir (matches LatencyHistogram)
            self.samples[self.n_done % self._max_samples] = latency_us

    def merge(self, other: "_Bucket") -> "_Bucket":
        self.n_done += other.n_done
        self.n_ok += other.n_ok
        self.n_miss += other.n_miss
        self.n_shed += other.n_shed
        self.rows += other.rows
        self.lat_sum_us += other.lat_sum_us
        room = self._max_samples - len(self.samples)
        if room > 0:
            self.samples.extend(other.samples[:room])
        return self

    def record(self, t_us: float, window_us: float) -> Dict[str, float]:
        s = np.asarray(self.samples) if self.samples else None
        slo_n = self.n_ok + self.n_miss + self.n_shed
        return {
            "t_us": t_us,
            "n": self.n_done,
            "shed": self.n_shed,
            "rows": self.rows,
            "qps": self.n_done / (window_us * 1e-6) if window_us else 0.0,
            "mean_us": (self.lat_sum_us / self.n_done
                        if self.n_done else 0.0),
            "p50_us": float(np.percentile(s, 50)) if s is not None else 0.0,
            "p99_us": float(np.percentile(s, 99)) if s is not None else 0.0,
            # attainment over deadline-carrying traffic incl. sheds; a
            # window with no such traffic reports None, never a fake 1.0
            "slo_attainment": (self.n_ok / slo_n if slo_n else None),
        }


class BucketRing:
    """Tumbling time buckets keyed by ``floor(ts / window_us)``.

    Holds at most ``n_windows`` live buckets; anything older than the
    retention horizon is evicted on write. Thread-safe — feeds arrive
    from scheduler and client threads.
    """

    _GUARDED_BY = {"_buckets": "_lock"}
    _LOCKED_METHODS = ("bucket",)

    def __init__(self, window_us: float, n_windows: int = 120,
                 max_samples: int = DEFAULT_BUCKET_SAMPLES):
        assert window_us > 0 and n_windows >= 1
        self.window_us = float(window_us)
        self.n_windows = int(n_windows)
        self._max_samples = max_samples
        self._buckets: Dict[int, _Bucket] = {}
        self._lock = threading.Lock()

    def _index(self, ts_us: float) -> int:
        return int(ts_us // self.window_us)

    def bucket(self, ts_us: float) -> _Bucket:
        """Get-or-create the bucket covering ``ts_us`` (caller must hold
        the lock); evicts buckets past the retention horizon."""
        idx = self._index(ts_us)
        b = self._buckets.get(idx)
        if b is None:
            b = self._buckets[idx] = _Bucket(self._max_samples)
            if len(self._buckets) > self.n_windows:
                floor = idx - self.n_windows + 1
                for k in [k for k in self._buckets if k < floor]:
                    del self._buckets[k]
        return b

    def add_done(self, ts_us: float, latency_us: float, ok: bool,
                 rows: int = 1, has_deadline: bool = True) -> None:
        with self._lock:
            self.bucket(ts_us).add_done(latency_us, ok, rows, has_deadline)

    def add_shed(self, ts_us: float) -> None:
        with self._lock:
            self.bucket(ts_us).n_shed += 1

    def merged(self, now_us: float, span_us: float) -> _Bucket:
        """One bucket summing everything in ``[now - span, now]``."""
        lo = self._index(now_us - span_us)
        hi = self._index(now_us)
        out = _Bucket(self._max_samples)
        with self._lock:
            for idx in range(lo, hi + 1):
                b = self._buckets.get(idx)
                if b is not None:
                    out.merge(b)
        return out

    def series(self, now_us: Optional[float] = None) -> List[Dict]:
        """All retained buckets as time-ordered records."""
        with self._lock:
            items = sorted(self._buckets.items())
        return [b.record(idx * self.window_us, self.window_us)
                for idx, b in items]


class WindowedMetrics:
    """Per-lane streaming window aggregation (a ``ServeMetrics`` sink).

    ``record_done``/``record_shed``/``record_batch`` match the sink
    protocol ``ServeMetrics`` forwards into; ``series()`` is the
    queryable product: per-lane tumbling-window time series of QPS,
    p50/p99 latency, SLO attainment and shed counts, plus a batch
    occupancy track. ``sliding(span_us)`` collapses the trailing span
    per lane — the view the burn-rate monitor consumes.
    """

    _GUARDED_BY = {"_lanes": "_lock", "_batches": "_lock"}
    # _last_ts is a monotonic high-water mark: a concurrent max() write
    # can only lose to a *newer* value, and sliding() treats it as an
    # advisory "now" — benign race, deliberately unguarded
    _LOCK_FREE = ("_last_ts",)

    def __init__(self, window_us: float = 1_000_000.0,
                 n_windows: int = 120,
                 max_samples: int = DEFAULT_BUCKET_SAMPLES):
        self.window_us = float(window_us)
        self.n_windows = int(n_windows)
        self._max_samples = max_samples
        self._lanes: Dict[int, BucketRing] = {}
        # batch track: (bucket idx -> [n, rows_sum, occ_sum, exec_sum])
        self._batches: Dict[int, List[float]] = {}
        self._last_ts = 0.0
        self._lock = threading.Lock()

    def _lane(self, lane: int) -> BucketRing:
        with self._lock:
            ring = self._lanes.get(lane)
            if ring is None:
                ring = self._lanes[lane] = BucketRing(
                    self.window_us, self.n_windows, self._max_samples)
            return ring

    # -- sink protocol -----------------------------------------------------
    def record_done(self, lane: int, latency_us: float, now_us: float,
                    ok: bool = True, rows: int = 1,
                    deadline_us: Optional[float] = None, **_kw) -> None:
        self._last_ts = max(self._last_ts, now_us)
        self._lane(lane).add_done(now_us, latency_us, ok, rows,
                                  has_deadline=deadline_us is not None)

    def record_shed(self, lane: int, now_us: float, **_kw) -> None:
        self._last_ts = max(self._last_ts, now_us)
        self._lane(lane).add_shed(now_us)

    def record_batch(self, rows: int, exec_us: float, now_us: float,
                     occupancy: float = 1.0, **_kw) -> None:
        self._last_ts = max(self._last_ts, now_us)
        idx = int(now_us // self.window_us)
        with self._lock:
            acc = self._batches.setdefault(idx, [0, 0.0, 0.0, 0.0])
            acc[0] += 1
            acc[1] += rows
            acc[2] += occupancy
            acc[3] += exec_us
            if len(self._batches) > self.n_windows:
                floor = idx - self.n_windows + 1
                for k in [k for k in self._batches if k < floor]:
                    del self._batches[k]

    # -- queries -----------------------------------------------------------
    def series(self) -> Dict:
        """Everything retained, as per-lane time-ordered window rows."""
        with self._lock:
            lanes = dict(self._lanes)
            batches = sorted(self._batches.items())
        return {
            "window_us": self.window_us,
            "lanes": {str(lane): ring.series()
                      for lane, ring in sorted(lanes.items())},
            "batches": [{
                "t_us": idx * self.window_us,
                "n_batches": int(n),
                "mean_rows": rows / n if n else 0.0,
                "mean_occupancy": occ / n if n else 0.0,
                "mean_exec_us": ex / n if n else 0.0,
            } for idx, (n, rows, occ, ex) in batches],
        }

    def sliding(self, span_us: float,
                now_us: Optional[float] = None) -> Dict[str, Dict]:
        """Trailing-``span_us`` merged record per lane (keys are lane
        ids as strings, matching ``ServeMetrics`` lane snapshots)."""
        now = self._last_ts if now_us is None else now_us
        with self._lock:
            lanes = dict(self._lanes)
        return {str(lane): ring.merged(now, span_us).record(
                    now - span_us, span_us)
                for lane, ring in sorted(lanes.items())}

    def publish(self, registry, name: str = "windows") -> None:
        """Expose the live series through a
        ``repro_torch.obs.MetricsRegistry`` snapshot provider."""
        registry.register(name, self.series)
