"""Thread-safe span tracer for the request lifecycle.

Two event families, mirroring the Chrome trace-event model so export is
a straight mapping:

  * **thread spans** (``ph="X"``) — work done start-to-finish on one
    thread: batch formation, aggregate pack, device exec, scatter.
    Nested calls on the same thread nest in Perfetto by time
    containment, so the aggregator's ``pack``/``device_exec`` spans
    render inside the scheduler's ``exec`` span with no extra plumbing.
  * **async spans** (``ph="b"/"n"/"e"``) — one per *request*, keyed by
    a tracer-allocated id threaded through ``ServeRequest``/
    ``ServeFuture``: begun retroactively at the request's enqueue
    timestamp when the scheduler first touches it (dispatch / shed /
    drain — the submit fast path records nothing but the id), ended at
    complete/shed/error. Async spans cross threads — enqueue time is
    stamped on the client thread, all recording happens scheduler-side
    — which is exactly what thread spans cannot express.

Storage is a lock-free ring: events are plain tuples appended to a
``deque(maxlen=capacity)`` and counted with ``itertools.count`` — both
single C calls, atomic under the GIL — so concurrent recorders never
serialize on a mutex and old events fall off the ring (``n_dropped``
counts them). ``TraceEvent`` objects are only materialized on the cold
``events()`` read path. The clock is injectable (``FakeClock`` in
tests); when the tracer is disabled — or the shared ``NULL_TRACER`` is
in use — every record call is a single attribute check, so the serving
hot path pays ~nothing for the instrumentation points it carries.

``program_tracer()`` is the process-wide ``ProgramTracer`` that the LM
engine, the decode step and the trainer record into. It records while
an operator has enabled it or while a ``torch.profiler`` session
records, stamps with the clock the profiler's events carry (Unix time),
opens a ``record_function`` range per span while the profiler records
and an operator has enabled it, and gives a span that asks for it a
device interval: the stream time between two CUDA events, resolved when
the events are read.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from itertools import count as _monotonic_count
from threading import get_ident
from typing import Dict, List, NamedTuple, Optional

# batch flush reasons annotated on batch-formation events; the trace
# validation pass (the reference's check --passes trace) rejects anything else
FLUSH_REASONS = ("size", "deadline", "max_wait", "drain", "shed")


class TraceEvent(NamedTuple):
    """One trace record (all times µs, from the tracer's clock).

    ``ph`` is the Chrome trace-event phase: ``X`` complete thread span
    (``dur_us`` set), ``b``/``n``/``e`` async begin/instant/end (keyed
    by ``scope_id``), ``i`` global instant.
    """

    ph: str
    name: str
    cat: str
    ts_us: float
    dur_us: float
    tid: int
    scope_id: Optional[int]
    args: Optional[Dict[str, object]]


class _Span:
    """Context manager recording one thread span on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer._now()
        return self

    def __exit__(self, *exc) -> None:
        # inlined tracer.complete(): X spans fire per batch phase on
        # the scheduler thread, so every frame saved is throughput
        tr = self._tracer
        next(tr._n)
        tr._buf.append(("X", self._name, self._cat, self._t0,
                        tr._now() - self._t0, get_ident(), None,
                        self._args))


class _NullSpan:
    """Shared no-op context manager for the disabled paths."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()
NULL_SPAN = _NULL_SPAN      # for call sites that skip building a span's args


class SpanTracer:
    """Ring-buffer span recorder with an injectable clock.

    ``capacity`` bounds memory: the buffer holds the most recent
    ``capacity`` events and ``n_dropped`` counts overwrites. All
    recording methods are thread-safe; ids from ``new_id`` are unique
    per tracer and are what requests carry across threads.
    """

    def __init__(self, clock=None, capacity: int = 1 << 16,
                 enabled: bool = True):
        if clock is None:
            from repro_torch.serve.clock import SystemClock
            clock = SystemClock()
        assert capacity >= 1
        self.clock = clock
        self.enabled = enabled
        self._cap = capacity
        # the hot path is lock-free: deque.append with a maxlen and
        # next() on an itertools.count are both single C calls, atomic
        # under the GIL, so 64 submitter threads recording concurrently
        # never serialize on a mutex. Events are stored as plain tuples
        # and only materialized into TraceEvent on the cold read path.
        self._buf: deque = deque(maxlen=capacity)
        self._n = _monotonic_count()    # total events ever recorded
        self._now = clock.now_us
        self._ids = _monotonic_count(1)
        self._lock = threading.Lock()   # clear only, never the hot path

    # -- ids / time --------------------------------------------------------
    def now_us(self) -> float:
        return self._now()

    def new_id(self) -> int:
        return next(self._ids)

    @property
    def n_recorded(self) -> int:
        # itertools.count exposes its next value through __reduce__;
        # reading it there peeks the total without consuming a tick
        return self._n.__reduce__()[1][0]

    @property
    def n_dropped(self) -> int:
        return max(0, self.n_recorded - self._cap)

    # -- recording ---------------------------------------------------------
    def complete(self, name: str, t0_us: float, t1_us: float,
                 cat: str = "sched", args: Optional[dict] = None) -> None:
        """A finished thread span with explicit endpoints (for spans
        whose start was stamped on another code path)."""
        if not self.enabled:
            return
        next(self._n)
        self._buf.append(("X", name, cat, t0_us, t1_us - t0_us,
                          get_ident(), None, args))

    def span(self, name: str, cat: str = "sched",
             args: Optional[dict] = None):
        """``with tracer.span("exec"): ...`` — times the block on the
        current thread."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "sched",
                args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        next(self._n)
        self._buf.append(("i", name, cat, self._now(), 0.0,
                          get_ident(), None, args))

    def abegin(self, name: str, scope_id: int, cat: str = "request",
               args: Optional[dict] = None,
               ts_us: Optional[float] = None) -> None:
        """Begin the async span ``scope_id`` (one per request)."""
        if not self.enabled:
            return
        next(self._n)
        self._buf.append(
            ("b", name, cat, self._now() if ts_us is None else ts_us,
             0.0, get_ident(), scope_id, args))

    def abegin_nested(self, outer: str, inner: str, scope_id: int,
                      ts_us: float, args: Optional[dict] = None) -> None:
        """Open an outer async span and an inner phase span at the same
        timestamp with one method dispatch — the submit-path fast path
        (``request`` + ``queue_wait``); ``args`` lands on the outer."""
        if not self.enabled:
            return
        next(self._n)
        next(self._n)
        tid = get_ident()
        self._buf.append(("b", outer, "request", ts_us, 0.0, tid,
                          scope_id, args))
        self._buf.append(("b", inner, "request", ts_us, 0.0, tid,
                          scope_id, None))

    def ainstant(self, name: str, scope_id: int, cat: str = "request",
                 args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        next(self._n)
        self._buf.append(("n", name, cat, self._now(), 0.0,
                          get_ident(), scope_id, args))

    def aend(self, name: str, scope_id: int, cat: str = "request",
             args: Optional[dict] = None,
             ts_us: Optional[float] = None) -> None:
        if not self.enabled:
            return
        next(self._n)
        self._buf.append(("e", name, cat,
                          self._now() if ts_us is None else ts_us, 0.0,
                          get_ident(), scope_id, args))

    # -- reading -----------------------------------------------------------
    def events(self) -> List[TraceEvent]:
        """Snapshot of the retained events in recording order."""
        # list(deque) is one atomic C call; the maxlen ring keeps
        # oldest-to-newest order by construction
        return [TraceEvent(*t) for t in list(self._buf)]

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._n = _monotonic_count()


class NullTracer:
    """Disabled tracer: same surface as ``SpanTracer``, every call a
    no-op. The scheduler default, so untraced serving carries only an
    ``if tracer.enabled`` per instrumentation point."""

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

    def events(self) -> List[TraceEvent]:
        return []

    def clear(self) -> None:
        pass


NULL_TRACER = NullTracer()


# ---------------------------------------------------------------------------
# The program tracer
# ---------------------------------------------------------------------------

class ProfilerClock:
    """The clock ``torch.profiler``'s events carry (Unix time), in µs,
    so a ring span and a device trace's operations share one timeline."""

    def now_us(self) -> float:
        return time.time_ns() / 1000


class _ProgramSpan:
    """One program span: the ring's host interval, a ``record_function``
    range while a profiler records and the tracer is enabled, and, asked
    for on a CUDA device, a pair of timing events on the device's current
    stream, kept in the span's args under ``_DEVICE_EVENTS`` until
    ``events()`` resolves them."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_device", "_t0",
                 "_range", "_ev0")

    def __init__(self, tracer: "ProgramTracer", name: str, cat: str,
                 args: Optional[dict], device):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args if device is None else dict(args or ())
        self._device = device

    def __enter__(self) -> "_ProgramSpan":
        tr = self._tracer
        # the ring's interval encloses the profiler's range of the span
        self._t0 = tr._now()
        self._range = None
        if tr._on and tr._profiler._is_profiler_enabled:
            self._range = tr._record_function(self._name)
            self._range.__enter__()
        self._ev0 = None
        if self._device is not None and self._device.type == "cuda":
            self._ev0 = tr._cuda.Event(enable_timing=True)
            self._ev0.record(tr._cuda.current_stream(self._device))
        return self

    def __exit__(self, *exc) -> None:
        tr = self._tracer
        if self._device is not None:
            interval = None
            if self._ev0 is not None:
                ev1 = tr._cuda.Event(enable_timing=True)
                ev1.record(tr._cuda.current_stream(self._device))
                interval = (self._ev0, ev1)
            self._args[_DEVICE_EVENTS] = interval
        if self._range is not None:
            self._range.__exit__(*exc)
        t1 = tr._now()
        next(tr._n)
        tr._buf.append(("X", self._name, self._cat, self._t0,
                        t1 - self._t0, get_ident(), None, self._args))


_DEVICE_EVENTS = "_device_events"


class ProgramTracer(SpanTracer):
    """The tracer the program's own paths record into.

    It records while ``enabled`` was set by an operator or while a
    ``torch.profiler`` session records (``enabled`` reads both: one
    check an instrumentation point, and nothing allocated, when neither
    holds). Its clock is ``ProfilerClock``. While a profiler records and
    an operator has enabled the tracer, each span also opens
    ``record_function(name)``, so the device's operations nest under the
    program's names. A profiler session alone fills the ring and leaves
    the profile as it would be without the program: a range around
    device work gains a device-side annotation in the profile, which a
    reader of its raw events would count as a device operation.
    ``span(..., device=d)`` on a CUDA device ``d`` records a timing event
    before and after the block on ``d``'s current stream and never
    synchronizes; ``events()`` (and so export) resolves the pair into
    ``args["device_ms"]``, the stream time between the two events, idle
    time inside it included (``None`` on other devices)."""

    def __init__(self, capacity: int = 1 << 16, enabled: bool = False):
        import torch
        from torch.autograd import profiler
        self._profiler = profiler
        self._record_function = profiler.record_function
        self._cuda = torch.cuda
        super().__init__(clock=ProfilerClock(), capacity=capacity,
                         enabled=enabled)

    @property
    def enabled(self) -> bool:
        return self._on or self._profiler._is_profiler_enabled

    @enabled.setter
    def enabled(self, on: bool) -> None:
        self._on = bool(on)

    def span(self, name: str, cat: str = "program",
             args: Optional[dict] = None, device=None):
        """``device`` asks for a device interval on that device."""
        if not self.enabled:
            return _NULL_SPAN
        return _ProgramSpan(self, name, cat, args, device)

    def instant(self, name: str, cat: str = "program",
                args: Optional[dict] = None) -> None:
        super().instant(name, cat, args)

    def events(self) -> List[TraceEvent]:
        """Snapshot in recording order, device intervals resolved (each
        end event waited for: read after the caller's own sync)."""
        out = []
        for t in list(self._buf):
            args = t[7]
            if args and _DEVICE_EVENTS in args:
                args = dict(args)
                interval = args.pop(_DEVICE_EVENTS)
                args["device_ms"] = None
                if interval is not None:
                    interval[1].synchronize()
                    args["device_ms"] = interval[0].elapsed_time(interval[1])
                t = t[:7] + (args,)
            out.append(TraceEvent(*t))
        return out


_program = None
_program_lock = threading.Lock()


def program_tracer() -> ProgramTracer:
    """The process-wide ``ProgramTracer``, made on first use (off until
    enabled or a profiler records)."""
    global _program
    if _program is None:
        with _program_lock:
            if _program is None:
                _program = ProgramTracer()
    return _program
