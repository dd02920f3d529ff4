"""The program's own spans, for the metrics that read them.

The port's program tracer (``repro_torch.obs.trace.program_tracer()``)
records while a profiler records, on the profiler's clock, so the spans
of a traced slice lie among the slice's harness spans. A reader takes
the events between the slice's first and last harness span, and keeps a
program span that encloses a harness span (``engine.decode`` holds
``perfbench:decode``). A program without the tracer gives no events,
and each reader then returns ``None``.
"""
from __future__ import annotations

from typing import List, Optional


def events() -> List:
    """The program tracer's events, [] where the program has none."""
    try:
        from repro_torch.obs.trace import program_tracer
    except ImportError:
        return []
    return program_tracer().events()


def us(ns: int) -> float:
    """A profiler time (int ns) in the ring's unit, rounded once."""
    return ns / 1000


def bounds_us(e):
    return e.ts_us, e.ts_us + e.dur_us


def in_slice(s, evs=None) -> List:
    """The events of ``evs`` (default: the program tracer's) inside the
    slice ``s``: from its first harness span's start to its last one's
    end, and those that enclose a harness span."""
    if not s.spans:
        return []
    evs = events() if evs is None else evs
    spans = [(us(sp.start_ns), us(sp.end_ns)) for sp in s.spans]
    lo = min(a for a, _ in spans)
    hi = max(b for _, b in spans)
    out = []
    for e in evs:
        a, b = bounds_us(e)
        if (lo <= a and b <= hi) or any(a <= c and d <= b for c, d in spans):
            out.append(e)
    return out


def named(evs, name: str) -> List:
    return [e for e in evs if e.name == name]


def device_ms(evs, name: str) -> Optional[float]:
    """The summed device interval (ms) of the spans ``name``; None
    without them or where one has no device interval."""
    spans = named(evs, name)
    ms = [(e.args or {}).get("device_ms") for e in spans]
    if not spans or any(m is None for m in ms):
        return None
    return float(sum(ms))


def args_of(evs, name: str, key: str) -> List[float]:
    return [float(e.args[key]) for e in named(evs, name)
            if e.args and key in e.args]
