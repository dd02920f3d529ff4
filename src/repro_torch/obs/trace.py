"""The disabled span tracer.

``NullTracer`` has the call surface of the reference package's span
tracer with every call a no-op, so untraced serving carries only an
``if tracer.enabled`` per instrumentation point. ``NULL_TRACER`` is the
shared instance the scheduler, the aggregator and ``BitplaneNetwork``
default to.
"""
from __future__ import annotations

from typing import List


class _NullSpan:
    """Shared no-op context manager for the disabled paths."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every call a no-op. The scheduler default, so
    untraced serving carries only an ``if tracer.enabled`` per
    instrumentation point."""

    enabled = False
    clock = None

    def now_us(self) -> float:
        return 0.0

    def new_id(self) -> int:
        return 0

    @property
    def n_recorded(self) -> int:
        return 0

    @property
    def n_dropped(self) -> int:
        return 0

    def complete(self, name, t0_us, t1_us, cat="sched", args=None) -> None:
        pass

    def span(self, name, cat="sched", args=None):
        return _NULL_SPAN

    def instant(self, name, cat="sched", args=None) -> None:
        pass

    def abegin(self, name, scope_id, cat="request", args=None,
               ts_us=None) -> None:
        pass

    def abegin_nested(self, outer, inner, scope_id, ts_us,
                      args=None) -> None:
        pass

    def ainstant(self, name, scope_id, cat="request", args=None) -> None:
        pass

    def aend(self, name, scope_id, cat="request", args=None,
             ts_us=None) -> None:
        pass

    def events(self) -> List[tuple]:
        return []

    def clear(self) -> None:
        pass


NULL_TRACER = NullTracer()
