"""Online continuous profiling: live device timings recalibrate serving.

``kernelprof`` calibrates the ``LatencyTable`` offline, on an idle
device; the scheduler's flush margin and ``least_slack`` EWMAs are then
seeded once and drift on their own. But a serving device is not an idle
device — thermals, co-tenants, host contention and batch shape all
move per-batch microseconds. ``OnlineProfiler`` closes the
loop with *sampled real traffic*:

  * the ``BitplaneAggregator`` times its ``device_exec`` section and
    reports ``(measured_us, rows)`` through ``on_device_us`` (a plain
    callback — the aggregator stays scheduler- and profiler-agnostic).
    The section ends when the labels reach the host, so on a card the
    sample is wall µs of host dispatch plus device time, not the
    kernel's device time alone;
  * every ``sample_every``-th observation, the profiler blends the
    measured/predicted ratio into ``LatencyTable.scale``
    (EWMA, clamped — one GC pause must not poison the margin);
  * the rescaled whole-plan estimate is pushed to
    ``MicroBatchScheduler.update_exec_estimate`` (flush margin) and
    ``ReplicaSet.reseed_exec_estimate`` (least-slack dispatch), so both
    track the live device instead of the calibration-day one.

The push happens on the executor thread *after* the batch completes —
the scheduler is not holding its condition lock while its executor
runs, so ``update_exec_estimate`` can take it without self-deadlock.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from .kernelprof import LatencyTable


class OnlineProfiler:
    """Blend sampled real-traffic device timings into a LatencyTable.

    Parameters
    ----------
    table:
        The calibrated ``LatencyTable`` to keep honest (its ``scale``
        field is the blend target).
    predicted_us:
        Whole-plan predicted device µs at the table's *current* scale
        (typically ``table.estimate_plan_us(dplan)``); the profiler
        normalizes out the scale so repeated blending converges on the
        true measured/calibrated ratio instead of compounding.
    sample_every:
        Blend every Nth observation (1 = every batch). Off-sample
        observations cost one counter increment.
    alpha:
        EWMA weight of each sampled ratio.
    min_rows:
        Ignore observations from batches smaller than this — a 1-row
        flush's per-call overhead is not the per-row device rate the
        table models.
    """

    _GUARDED_BY = {"_sched": "_lock", "_replicas": "_lock",
                   "n_observed": "_lock", "n_sampled": "_lock",
                   "last_measured_us": "_lock"}

    def __init__(self, table: LatencyTable, predicted_us: float,
                 sample_every: int = 16, alpha: float = 0.2,
                 min_rows: int = 1):
        if predicted_us <= 0:
            raise ValueError(f"predicted_us must be > 0, "
                             f"got {predicted_us}")
        self.table = table
        # prediction at scale 1.0: the stable denominator of the ratio
        self._base_us = predicted_us / table.scale
        self.sample_every = max(int(sample_every), 1)
        self.alpha = float(alpha)
        self.min_rows = int(min_rows)
        self._sched = None
        self._replicas = []
        self.n_observed = 0
        self.n_sampled = 0
        self.last_measured_us: Optional[float] = None
        self._lock = threading.Lock()

    # -- wiring ------------------------------------------------------------
    def attach(self, scheduler=None, replicas=None) -> "OnlineProfiler":
        """Register consumers to push rescaled estimates into.

        Takes the lock: attach() may race an in-flight observe() on the
        executor thread when consumers are wired after traffic starts.
        """
        with self._lock:
            if scheduler is not None:
                self._sched = scheduler
            if replicas is not None:
                self._replicas.append(replicas)
        return self

    @property
    def estimate_us(self) -> float:
        """Whole-plan estimate at the current blended scale."""
        return self._base_us * self.table.scale

    # -- the aggregator callback -------------------------------------------
    def observe(self, measured_us: float, rows: int = 0) -> None:
        """One real-traffic device timing (``on_device_us`` target)."""
        with self._lock:
            self.n_observed += 1
            if (measured_us <= 0 or (rows and rows < self.min_rows)
                    or self.n_observed % self.sample_every):
                return
            self.n_sampled += 1
            self.last_measured_us = float(measured_us)
            self.table.blend_scale(measured_us / self._base_us,
                                   alpha=self.alpha)
            est = self.estimate_us
            sched, replicas = self._sched, list(self._replicas)
        # push outside our lock: consumers take their own locks and
        # nothing here may run under the scheduler's condition
        if sched is not None:
            sched.update_exec_estimate(est)
        for rs in replicas:
            rs.reseed_exec_estimate(est)

    # -- reporting ---------------------------------------------------------
    def stats(self) -> Dict:
        with self._lock:
            return {"n_observed": self.n_observed,
                    "n_sampled": self.n_sampled,
                    "sample_every": self.sample_every,
                    "scale": self.table.scale,
                    "base_us": self._base_us,
                    "estimate_us": self.estimate_us,
                    "last_measured_us": self.last_measured_us}

    def publish(self, registry, name: str = "online_profile") -> None:
        """Expose blend state through a ``repro_torch.obs.MetricsRegistry``
        snapshot provider."""
        registry.register(name, self.stats)
