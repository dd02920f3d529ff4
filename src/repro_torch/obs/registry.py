"""Unified metrics registry: counters, gauges, histograms, providers.

Before this module every stats surface in the repo was its own island:
``ServeMetrics.snapshot()``, ``ReplicaSet.stats()``, the
``BitplaneAggregator`` occupancy counters. The registry gives them one
roof — components either allocate typed instruments (``counter`` /
``gauge`` / ``histogram``) or register a zero-argument *provider*
callable whose dict is evaluated lazily at ``snapshot()`` time (the
natural fit for objects that already maintain their own locked state).
One ``snapshot()`` call returns everything, which is what benchmark
JSON writers, the launcher's shutdown report, and trace ``otherData``
embed.

Instrument updates are lock-protected and cheap; ``snapshot()`` is the
only place provider callables run, so registering a provider adds zero
steady-state cost to the hot path.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from repro_torch.serve.metrics import LatencyHistogram


class Counter:
    """Monotonic counter (thread-safe)."""

    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v


class Gauge:
    """Last-value gauge; either set explicitly or backed by a callable
    evaluated at snapshot time."""

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self._v = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        self._v = float(v)

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        return self._v


class MetricsRegistry:
    """Get-or-create instrument registry with one snapshot surface.

    Names are dotted paths by convention (``sched.completed``,
    ``replicas.0.ewma_us``); providers publish a whole nested dict
    under their name. Re-requesting an existing name returns the same
    instrument, so publishers never need to coordinate creation order.
    """

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, LatencyHistogram] = {}
        self._providers: Dict[str, Callable[[], Dict]] = {}
        self._lock = threading.Lock()

    # -- instruments -------------------------------------------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter()
            return self._counters[name]

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(fn)
            elif fn is not None:
                self._gauges[name]._fn = fn
            return self._gauges[name]

    def histogram(self, name: str,
                  max_samples: int = 200_000) -> LatencyHistogram:
        with self._lock:
            if name not in self._hists:
                self._hists[name] = LatencyHistogram(max_samples)
            return self._hists[name]

    def register(self, name: str, provider: Callable[[], Dict]) -> None:
        """Publish a component's own stats dict under ``name``; the
        callable runs at every ``snapshot()``."""
        with self._lock:
            self._providers[name] = provider

    # -- reporting ---------------------------------------------------------
    def snapshot(self) -> Dict:
        """Everything, in one dict:

        ``{"counters": {...}, "gauges": {...}, "histograms":
        {name: {n, mean_us, p50_us, p95_us, p99_us, buckets}},
        <provider name>: <provider dict>, ...}``
        """
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
            providers = dict(self._providers)
        out: Dict = {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {
                k: {"n": h.n, "mean_us": h.mean(),
                    "p50_us": h.percentile(50), "p95_us": h.percentile(95),
                    "p99_us": h.percentile(99), "buckets": h.buckets()}
                for k, h in sorted(hists.items())},
        }
        for name, fn in sorted(providers.items()):
            out[name] = fn()
        return out
