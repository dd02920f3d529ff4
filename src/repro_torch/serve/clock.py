"""Injectable clocks: the scheduler never reads wall time directly.

Everything time-dependent in ``repro_torch.serve`` (batch deadlines, latency
stamps, Poisson arrival pacing) goes through a ``Clock`` so tests drive
the scheduler deterministically with ``FakeClock`` while production uses
``SystemClock``. All times are microseconds — the unit the paper's
sub-microsecond story is told in.
"""
from __future__ import annotations

import time


class SystemClock:
    """Monotonic wall clock (perf_counter) in microseconds."""

    def now_us(self) -> float:
        return time.perf_counter() * 1e6

    def sleep_us(self, us: float) -> None:
        if us > 0:
            time.sleep(us * 1e-6)


class FakeClock:
    """Deterministic test clock: time moves only via ``advance``/``sleep``."""

    def __init__(self, start_us: float = 0.0):
        self._now = float(start_us)

    def now_us(self) -> float:
        return self._now

    def advance_us(self, us: float) -> None:
        assert us >= 0, "time cannot move backwards"
        self._now += us

    def sleep_us(self, us: float) -> None:
        self.advance_us(max(0.0, us))
