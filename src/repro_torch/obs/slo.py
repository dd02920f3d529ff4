"""Multi-window SLO burn-rate monitoring with degradation alerts.

The per-lane SLO tables (PR 5) make individual requests deadline-aware;
nothing yet watches the *rate* at which a lane is spending its error
budget. This module implements the standard SRE multi-window burn-rate
rule:

  * a lane's **error budget** is ``1 - slo_target`` (target 0.99 →
    budget 1% of deadline-carrying requests may miss or be shed);
  * the **burn rate** over a window is ``miss_fraction / budget`` —
    burn 1.0 spends the budget exactly at the sustainable rate, burn
    10 spends a day of budget in ~2.4 hours;
  * an alert **fires** only when both a long and a short window exceed
    the threshold — the long window proves the problem is real (not one
    bad batch), the short window proves it is *still happening* (fast
    reset once the cause clears);
  * the alert **clears** with hysteresis when the short-window burn
    drops below ``clear_threshold`` — flapping between degraded and
    normal admission would shed in bursts, the worst of both modes.

``BurnRateMonitor`` is a ``ServeMetrics`` sink (same push protocol as
``WindowedMetrics``) built on the same tumbling ``BucketRing``; it is
scheduler-agnostic — ``check(now_us)`` evaluates the rule and invokes
registered alert callbacks. ``MicroBatchScheduler(slo_monitor=...)``
wires it as the degradation hook: while any lane's alert is active, the
scheduler sheds the *loosest* lane (largest SLO budget — the traffic
whose latency promise costs least to break) at admission with a typed
``RequestRejected(DEGRADED)``, freeing capacity for the lanes that are
burning.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple

from .window import BucketRing


@dataclasses.dataclass(frozen=True)
class BurnAlert:
    """One alert transition (``kind`` = ``"fire"`` or ``"clear"``)."""

    kind: str
    lane: int
    burn_long: float
    burn_short: float
    threshold: float
    now_us: float

    def __str__(self) -> str:
        return (f"[slo] {self.kind}: lane {self.lane} burn "
                f"long={self.burn_long:.1f}x short={self.burn_short:.1f}x "
                f"(threshold {self.threshold:.1f}x) at t={self.now_us:.0f}us")


class BurnRateMonitor:
    """Per-lane multi-window burn-rate evaluation over pushed events.

    Parameters
    ----------
    slo_target:
        Attainment objective in (0, 1); the error budget is its
        complement.
    long_window_us / short_window_us:
        The two evaluation windows; both must exceed ``threshold``
        burn for an alert to fire.
    threshold:
        Burn-rate multiple that fires the alert.
    clear_threshold:
        Short-window burn below which an active alert clears
        (hysteresis; must be <= threshold).
    min_events:
        Minimum deadline-carrying events in the long window before the
        rule is evaluated — two misses out of three requests is noise,
        not a burn.
    """

    _GUARDED_BY = {"_lanes": "_lock", "_active": "_lock",
                   "_history": "_lock"}
    # callbacks are registered during wiring, before traffic flows, and
    # only appended — check() iterates a list that never shrinks, so
    # the list itself needs no lock (callbacks run outside it anyway)
    _LOCK_FREE = ("_callbacks",)

    def __init__(self, slo_target: float = 0.99,
                 long_window_us: float = 60_000_000.0,
                 short_window_us: float = 5_000_000.0,
                 threshold: float = 10.0,
                 clear_threshold: float = 1.0,
                 min_events: int = 20,
                 clock=None):
        if not 0.0 < slo_target < 1.0:
            raise ValueError(f"slo_target must be in (0, 1), "
                             f"got {slo_target}")
        if short_window_us >= long_window_us:
            raise ValueError("short window must be shorter than long "
                             f"({short_window_us} >= {long_window_us})")
        if clear_threshold > threshold:
            raise ValueError("clear_threshold above threshold would "
                             "re-fire immediately after every clear")
        self.slo_target = float(slo_target)
        self.budget = 1.0 - self.slo_target
        self.long_window_us = float(long_window_us)
        self.short_window_us = float(short_window_us)
        self.threshold = float(threshold)
        self.clear_threshold = float(clear_threshold)
        self.min_events = int(min_events)
        self.clock = clock
        # bucket the long window into short-window-sized cells so the
        # short view is exact and the long view is a cheap merge
        n = max(2, int(long_window_us // short_window_us) + 2)
        self._mk_ring = lambda: BucketRing(short_window_us, n_windows=n)
        self._lanes: Dict[int, BucketRing] = {}
        self._active: Dict[int, BurnAlert] = {}
        self._history: List[BurnAlert] = []
        self._callbacks: List[Callable[[BurnAlert], None]] = []
        self._lock = threading.Lock()

    # -- wiring ------------------------------------------------------------
    def on_alert(self, cb: Callable[[BurnAlert], None]) -> None:
        """Register a callback invoked on every fire/clear transition.

        Callbacks run inside ``check()`` on the calling thread (the
        scheduler may hold its lock there) — keep them fast and never
        call back into the scheduler from one."""
        self._callbacks.append(cb)

    def _lane(self, lane: int) -> BucketRing:
        with self._lock:
            ring = self._lanes.get(lane)
            if ring is None:
                ring = self._lanes[lane] = self._mk_ring()
            return ring

    # -- sink protocol (pushed by ServeMetrics) ----------------------------
    def record_done(self, lane: int, latency_us: float, now_us: float,
                    ok: bool = True, deadline_us: Optional[float] = None,
                    **_kw) -> None:
        # deadline-free traffic has no budget to burn: skip it so one
        # best-effort lane cannot dilute a burning SLO lane's rate
        if deadline_us is None:
            return
        self._lane(lane).add_done(now_us, latency_us, ok)

    def record_shed(self, lane: int, now_us: float, **_kw) -> None:
        self._lane(lane).add_shed(now_us)

    # -- evaluation --------------------------------------------------------
    def burn_rate(self, lane: int, window_us: float,
                  now_us: float) -> Tuple[float, int]:
        """(burn multiple, deadline-carrying events) over the trailing
        window; burn is 0 when the window carried no such traffic."""
        b = self._lane(lane).merged(now_us, window_us)
        n = b.n_ok + b.n_miss + b.n_shed
        if n == 0:
            return 0.0, 0
        return ((b.n_miss + b.n_shed) / n) / self.budget, n

    def check(self, now_us: Optional[float] = None) -> List[BurnAlert]:
        """Evaluate the multi-window rule for every lane seen so far;
        returns the alert *transitions* (fires and clears) this call
        produced, after invoking the registered callbacks on each."""
        if now_us is None:
            if self.clock is None:
                raise ValueError("check() needs now_us (no clock bound)")
            now_us = self.clock.now_us()
        with self._lock:
            lanes = list(self._lanes)
        out: List[BurnAlert] = []
        for lane in lanes:
            burn_long, n_long = self.burn_rate(lane, self.long_window_us,
                                               now_us)
            burn_short, _ = self.burn_rate(lane, self.short_window_us,
                                           now_us)
            with self._lock:
                active = lane in self._active
                if (not active and n_long >= self.min_events
                        and burn_long > self.threshold
                        and burn_short > self.threshold):
                    alert = BurnAlert("fire", lane, burn_long, burn_short,
                                      self.threshold, now_us)
                    self._active[lane] = alert
                elif active and burn_short < self.clear_threshold:
                    alert = BurnAlert("clear", lane, burn_long, burn_short,
                                      self.threshold, now_us)
                    del self._active[lane]
                else:
                    continue
                self._history.append(alert)
            out.append(alert)
            for cb in self._callbacks:
                cb(alert)
        return out

    def alerting_lanes(self) -> List[int]:
        """Lanes with an active (fired, not yet cleared) alert."""
        with self._lock:
            return sorted(self._active)

    def history(self) -> List[BurnAlert]:
        with self._lock:
            return list(self._history)

    # -- reporting ---------------------------------------------------------
    def stats(self, now_us: Optional[float] = None) -> Dict:
        now = now_us
        if now is None and self.clock is not None:
            now = self.clock.now_us()
        with self._lock:
            lanes = list(self._lanes)
            active = sorted(self._active)
            n_fired = sum(1 for a in self._history if a.kind == "fire")
        out: Dict = {"slo_target": self.slo_target,
                     "threshold": self.threshold,
                     "alerting_lanes": active, "alerts_fired": n_fired,
                     "lanes": {}}
        if now is not None:
            for lane in lanes:
                bl, nl = self.burn_rate(lane, self.long_window_us, now)
                bs, ns = self.burn_rate(lane, self.short_window_us, now)
                out["lanes"][str(lane)] = {
                    "burn_long": round(bl, 3), "burn_short": round(bs, 3),
                    "events_long": nl, "events_short": ns,
                    "alerting": lane in active}
        return out

    def publish(self, registry, name: str = "slo_burn") -> None:
        """Expose burn state through a ``repro_torch.obs.MetricsRegistry``
        snapshot provider."""
        registry.register(name, self.stats)
