"""Event-driven micro-batch scheduler with an injectable clock.

The core is a deterministic discrete-event engine: ``submit`` enqueues
into bounded priority lanes (typed reject on overflow), ``poll`` forms
and executes batches — flush when ``max_batch`` rows are waiting, when
the oldest request has aged past ``max_wait_us``, or when the tightest
SLO deadline in the queue can no longer absorb further fill-wait,
whichever comes first. Nothing inside reads wall time except through
the injected clock, so a ``FakeClock`` test steps the exact same code
path production runs.

Deadlines are first-class: every request carries an absolute
``deadline_us`` (explicit per-request budget, or defaulted from the
per-lane SLO table ``SchedConfig.lane_slo_us`` — e.g. lane 0 = 100 µs,
lane 1 = 1 ms). Batch formation is earliest-deadline-first within each
priority lane, and a request that is already past its deadline is
*shed*: its future fails with a typed
``RequestRejected(DEADLINE_EXCEEDED)`` instead of silently riding a
late batch — under overload the paper's fixed-latency story demands a
fast "no" over a slow "yes".

Two drivers sit on top of the core:
  * synchronous — ``poll``/``drain`` called by the owner (tests, the
    ``serve_queue`` compatibility wrapper, simulated loadgen);
  * threaded — ``start()`` spawns a flush loop that sleeps until the
    earliest flush obligation (SLO deadline or age cap) and wakes on
    submit (real-time open-loop serving).

The executor contract is one callable ``(B, ...) -> (B,)``: it receives
the concatenated rows of every request in the batch and returns one
result row per input row. Executors may additionally accept a
``deadline_us`` keyword (the tightest absolute deadline in the batch;
detected by signature inspection) and may expose ``n_features`` so
admission can reject wrong-width payloads before they poison a batch.
``repro_torch.serve.aggregate.BitplaneAggregator`` and
``repro_torch.serve.replica.ReplicaSet`` both satisfy the extended
contract.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import inspect
import math
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.trace import NULL_TRACER

from .clock import SystemClock
from .metrics import ServeMetrics

# ---------------------------------------------------------------------------
# Futures + typed rejection
# ---------------------------------------------------------------------------


class RejectReason:
    QUEUE_FULL = "queue_full"
    SHUTDOWN = "shutdown"
    TOO_LARGE = "too_large"
    BAD_PRIORITY = "bad_priority"
    BAD_SHAPE = "bad_shape"
    DEADLINE_EXCEEDED = "deadline_exceeded"
    DEGRADED = "degraded"       # burn-rate degradation shed (loosest lane)


class RequestRejected(RuntimeError):
    """Admission-control reject; ``reason`` is a ``RejectReason`` value."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"request rejected ({reason}){': ' if detail else ''}"
                         f"{detail}")
        self.reason = reason


class ServeFuture:
    """Thread-safe single-assignment result slot for one request."""

    def __init__(self):
        self._ev = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self.t_enqueue_us: float = 0.0
        self.t_done_us: float = 0.0
        # LM admission stamps (``LMEngine``): slot taken, first token out
        self.t_admit_us: float = 0.0
        self.t_first_token_us: float = 0.0
        self.trace_id: Optional[int] = None

    def done(self) -> bool:
        return self._ev.is_set()

    def set_result(self, value) -> None:
        self._result = value
        self._ev.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._ev.set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("request still pending")
        if self._exc is not None:
            raise self._exc
        return self._result

    @property
    def latency_us(self) -> float:
        return self.t_done_us - self.t_enqueue_us


@dataclasses.dataclass
class ServeRequest:
    x: object                   # (rows, ...) payload (or an LMRequest)
    rows: int
    priority: int
    t_enqueue_us: float
    future: ServeFuture
    deadline_us: float = math.inf   # absolute SLO deadline (inf = none)
    seq: int = 0                    # admission order (EDF tie-break)
    queued: bool = False            # live in a BoundedPriorityQueue lane
    trace_id: Optional[int] = None  # async-span id (None when untraced)

    def slack_us(self, now_us: float) -> float:
        """Remaining budget; negative once the deadline has passed."""
        return self.deadline_us - now_us


# ---------------------------------------------------------------------------
# Bounded priority lanes (shared with LMEngine admission)
# ---------------------------------------------------------------------------

class BoundedPriorityQueue:
    """EDF-within-lane priority queue with bounded total occupancy.

    Lane 0 is the highest priority. Within a lane, requests are held in
    earliest-deadline-first order (ties broken by admission order, so
    deadline-free traffic stays FIFO). ``push`` raises
    ``RequestRejected`` instead of blocking — backpressure is the
    caller's signal to shed load, the serving analogue of the paper's
    fixed-capacity fabric.
    """

    def __init__(self, max_queue: int, n_priorities: int = 2):
        assert n_priorities >= 1
        self.max_queue = max_queue
        self.lanes: List[List[ServeRequest]] = [
            [] for _ in range(n_priorities)]
        self._len = 0
        self._rows = 0
        self._seq = 0
        # min-heap of (t_enqueue_us, seq, req) with lazy deletion (dead
        # entries skipped via req.queued), so the oldest-arrival peek
        # stays O(log n) amortized while lanes hold EDF order
        self._arrivals: List[Tuple[float, int, ServeRequest]] = []

    def __len__(self) -> int:
        return self._len

    @property
    def rows(self) -> int:
        return self._rows

    def push(self, req: ServeRequest) -> None:
        if not 0 <= req.priority < len(self.lanes):
            raise RequestRejected(
                RejectReason.BAD_PRIORITY,
                f"priority {req.priority} not in [0, {len(self.lanes)})")
        if self._len >= self.max_queue:
            raise RequestRejected(
                RejectReason.QUEUE_FULL,
                f"{self._len} requests already queued (max {self.max_queue})")
        req.seq = self._seq
        self._seq += 1
        bisect.insort(self.lanes[req.priority], req,
                      key=lambda r: (r.deadline_us, r.seq))
        req.queued = True
        heapq.heappush(self._arrivals, (req.t_enqueue_us, req.seq, req))
        self._len += 1
        self._rows += req.rows

    def _unlink(self, lane: List[ServeRequest], idx: int) -> ServeRequest:
        req = lane.pop(idx)
        req.queued = False
        self._len -= 1
        self._rows -= req.rows
        return req

    def oldest_enqueue_us(self) -> Optional[float]:
        h = self._arrivals
        while h and not h[0][2].queued:     # lazy-delete popped requests
            heapq.heappop(h)
        return h[0][0] if h else None

    def earliest_flush_us(self, max_wait_us: float,
                          margin_us: float = 0.0) -> Optional[float]:
        """Earliest instant any queued request must be dispatched: the
        oldest arrival's age cap (``t_enqueue + max_wait_us``) or the
        tightest SLO deadline minus ``margin_us`` (the execution-time
        estimate — the last moment a flush can still complete in
        budget), whichever is sooner. None when idle. O(lanes) plus the
        amortized arrival-heap peek — lanes are EDF-sorted, so each
        lane's tightest deadline is its head."""
        oldest = self.oldest_enqueue_us()
        if oldest is None:
            return None
        best = oldest + max_wait_us
        for lane in self.lanes:
            if lane and math.isfinite(lane[0].deadline_us):
                best = min(best, lane[0].deadline_us - margin_us)
        return best

    def shed_expired(self, now_us: float) -> List[ServeRequest]:
        """Remove and return every request already past its deadline.

        EDF order puts expired requests at the front of each lane, so
        this is a prefix pop per lane."""
        out: List[ServeRequest] = []
        for lane in self.lanes:
            while lane and now_us > lane[0].deadline_us:
                out.append(self._unlink(lane, 0))
        return out

    def pop_batch(self, max_rows: int) -> List[ServeRequest]:
        """Highest-priority-first batch of whole requests, EDF within
        each lane, up to ``max_rows`` total rows; stops at the first
        head-of-line request that does not fit (no within-lane
        reordering past the deadline order)."""
        out: List[ServeRequest] = []
        rows = 0
        for lane in self.lanes:
            while lane and rows + lane[0].rows <= max_rows:
                req = self._unlink(lane, 0)
                out.append(req)
                rows += req.rows
            if lane and out and rows + lane[0].rows > max_rows:
                break
        return out

    def pop_all(self) -> List[ServeRequest]:
        out: List[ServeRequest] = []
        for lane in self.lanes:
            out.extend(lane)
            lane.clear()
        for req in out:
            req.queued = False
        self._arrivals.clear()
        self._len = 0
        self._rows = 0
        return out


# ---------------------------------------------------------------------------
# The scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SchedConfig:
    max_batch: int = 256          # flush at this many rows ...
    max_wait_us: float = 200.0    # ... or when the oldest waits this long
    max_queue: int = 4096         # admission bound, in requests
    n_priorities: int = 2
    # Per-lane SLO table: lane i's default deadline budget (µs from
    # enqueue), e.g. (100.0, 1000.0) = lane 0 must complete in 100 µs,
    # lane 1 in 1 ms. None (or a missing lane entry) = no deadline;
    # an explicit ``submit(..., deadline_us=...)`` always wins.
    lane_slo_us: Optional[Tuple[float, ...]] = None
    # Calibrated batch-execution estimate (µs) seeding the flush-margin
    # EWMA, e.g. ``LatencyTable.estimate_plan_us`` from
    # ``repro.obs.kernelprof`` — without it the first deadline-margin
    # flush decisions run on a cold 0 µs estimate.
    exec_estimate_us: Optional[float] = None

    def slo_for_lane(self, lane: int) -> float:
        if self.lane_slo_us is None or lane >= len(self.lane_slo_us):
            return math.inf
        return float(self.lane_slo_us[lane])


class MicroBatchScheduler:
    """Deadline-aware micro-batching over an executor callable.

    ``executor(x_batch) -> results`` is called with the row-concatenated
    payloads of a batch; results are scattered back to each request's
    future, stamped with true enqueue→complete latency. Executors that
    accept a ``deadline_us`` keyword receive the tightest absolute
    deadline in the batch (least-slack replica dispatch, failover
    budget re-stamping); executors exposing ``n_features`` get
    wrong-width payloads rejected at admission instead of poisoning a
    whole batch.
    """

    # lock-discipline contract, enforced by repro.check's concurrency
    # lint: these fields may only be touched under ``with self._cond:``
    # (outside __init__). _exec_ewma_us/_n_execs are deliberately not
    # listed: they are written by whichever single thread drives poll()
    # and only read under the lock as a flush-timing *estimate*, where a
    # stale value is harmless.
    _GUARDED_BY = {
        "_stopping": "_cond",
        "_shutdown": "_cond",
        "_n_features": "_cond",
        "_monitor_next_us": "_cond",
    }
    # helpers that require _cond already held by the caller
    _LOCKED_METHODS = ("_degraded_check",)

    def __init__(self, executor: Callable[[np.ndarray], Sequence],
                 cfg: Optional[SchedConfig] = None, clock=None,
                 metrics: Optional[ServeMetrics] = None, tracer=None,
                 slo_monitor=None):
        self.executor = executor
        self.cfg = cfg or SchedConfig()
        self.clock = clock or SystemClock()
        self.metrics = metrics or ServeMetrics(max_batch=self.cfg.max_batch)
        # optional degradation hook (repro.obs.slo.BurnRateMonitor): the
        # monitor is fed as a metrics sink; admission evaluates its
        # multi-window rule (rate-limited) and, while any lane's alert
        # is active, sheds the *loosest* lane with a typed
        # RequestRejected(DEGRADED) — breaking the cheapest latency
        # promise to free capacity for the lanes burning budget.
        # Monitor alert callbacks run on the admitting thread, possibly
        # under self._cond: they must never call back into this
        # scheduler.
        self.slo_monitor = slo_monitor
        self._degrade_lane = self._loosest_lane()
        self._monitor_next_us = -math.inf
        self._monitor_interval_us = (
            max(slo_monitor.short_window_us / 8.0, 100.0)
            if slo_monitor is not None else 0.0)
        if slo_monitor is not None:
            self.metrics.add_sink(slo_monitor)
        # tracer and scheduler should share a clock so span timestamps
        # line up with enqueue stamps; callers constructing a
        # SpanTracer(clock=...) around the same clock get exact nesting
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if tracer is not None and hasattr(executor, "set_tracer"):
            executor.set_tracer(tracer)
        self.queue = BoundedPriorityQueue(self.cfg.max_queue,
                                          self.cfg.n_priorities)
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._shutdown = False
        # smoothed batch execution time; a calibrated kernelprof
        # estimate seeds it so the first flush margins aren't cold
        self._exec_ewma_us = float(self.cfg.exec_estimate_us or 0.0)
        self._ewma_seeded = self.cfg.exec_estimate_us is not None
        self._n_execs = 0
        self._n_features = getattr(executor, "n_features", None)
        try:
            params = inspect.signature(executor).parameters
            self._pass_deadline = "deadline_us" in params
        except (TypeError, ValueError):
            self._pass_deadline = False

    # -- admission ---------------------------------------------------------
    def _loosest_lane(self) -> int:
        """The degradation victim: the lane with the largest SLO budget
        (deadline-free lanes count as infinitely loose; ties go to the
        lower-priority index)."""
        budgets = [(self.cfg.slo_for_lane(i), i)
                   for i in range(self.cfg.n_priorities)]
        return max(budgets)[1]

    def _degraded_check(self, now_us: float, priority: int) -> bool:
        """Evaluate the burn-rate monitor (rate-limited) and decide
        whether this submit is shed by degradation. Caller holds
        ``self._cond``."""
        mon = self.slo_monitor
        if mon is None:
            return False
        if now_us >= self._monitor_next_us:
            self._monitor_next_us = now_us + self._monitor_interval_us
            mon.check(now_us)
        return priority == self._degrade_lane and bool(
            mon.alerting_lanes())

    def _payload_width(self, x: np.ndarray) -> int:
        return 1 if x.ndim == 0 else int(x.shape[-1])

    def _note_reject(self, reason: str) -> None:
        """Count an admission reject and mark it in the trace (a
        rejected request never gets an async span — the instant is its
        whole story)."""
        self.metrics.record_reject(reason)
        self.tracer.instant("reject", cat="admission",
                            args={"reason": reason})

    def submit(self, x, priority: int = 0,
               deadline_us: Optional[float] = None) -> ServeFuture:
        """Admit one request (a single sample or a (B, ...) row block).

        ``deadline_us`` is the request's latency budget in µs *from
        enqueue* (its absolute deadline is ``now + deadline_us``); when
        omitted, the lane's ``SchedConfig.lane_slo_us`` entry applies
        (no deadline if the table is unset).

        Raises ``RequestRejected`` — typed, never blocks — when the
        queue is full, the payload exceeds one batch or has the wrong
        feature width, the budget is already spent, or the scheduler is
        shut down.
        """
        x = np.asarray(x)
        rows = 1 if x.ndim <= 1 else x.shape[0]
        if rows > self.cfg.max_batch:
            self._note_reject(RejectReason.TOO_LARGE)
            raise RequestRejected(
                RejectReason.TOO_LARGE,
                f"{rows} rows > max_batch {self.cfg.max_batch}")
        if x.ndim > 2:
            self._note_reject(RejectReason.BAD_SHAPE)
            raise RequestRejected(
                RejectReason.BAD_SHAPE,
                f"payload rank {x.ndim} > 2 (want (features,) or "
                f"(rows, features))")
        budget = (self.cfg.slo_for_lane(priority)
                  if deadline_us is None else float(deadline_us))
        if budget <= 0:
            self._note_reject(RejectReason.DEADLINE_EXCEEDED)
            raise RequestRejected(
                RejectReason.DEADLINE_EXCEEDED,
                f"non-positive deadline budget {budget} µs")
        width = self._payload_width(x)
        fut = ServeFuture()
        now = self.clock.now_us()
        fut.t_enqueue_us = now
        req = ServeRequest(x=x, rows=rows, priority=priority,
                           t_enqueue_us=now, future=fut,
                           deadline_us=now + budget)
        tracer = self.tracer
        if tracer.enabled:
            req.trace_id = fut.trace_id = tracer.new_id()
        with self._cond:
            if self._shutdown:
                self._note_reject(RejectReason.SHUTDOWN)
                raise RequestRejected(RejectReason.SHUTDOWN)
            if self._degraded_check(now, priority):
                self._note_reject(RejectReason.DEGRADED)
                raise RequestRejected(
                    RejectReason.DEGRADED,
                    f"lane {priority} shed while SLO burn rate is over "
                    f"threshold on lane(s) "
                    f"{self.slo_monitor.alerting_lanes()}")
            # width check + first-payload pinning share the lock, so two
            # concurrent first submits cannot both pass with different
            # widths and poison the same batch's concatenation
            if self._n_features is not None and width != self._n_features:
                self._note_reject(RejectReason.BAD_SHAPE)
                raise RequestRejected(
                    RejectReason.BAD_SHAPE,
                    f"payload width {width} != executor width "
                    f"{self._n_features}")
            try:
                self.queue.push(req)
            except RequestRejected as e:
                self._note_reject(e.reason)
                raise
            if self._n_features is None and x.ndim > 0:
                self._n_features = width
            self.metrics.record_enqueue(len(self.queue), now)
            self._cond.notify_all()
        return fut

    def update_exec_estimate(self, us: float) -> None:
        """Re-seed the batch-execution estimate with a fresher
        calibration (``repro.obs.online.OnlineProfiler`` pushes the
        blended live-device estimate here). Subsequent measured batches
        keep blending into it through the normal EWMA."""
        self._exec_ewma_us = float(us)
        self._ewma_seeded = True

    # -- event engine ------------------------------------------------------
    def next_deadline_us(self) -> Optional[float]:
        """Earliest instant a flush is owed: the tightest queued SLO
        deadline (minus the batch-execution estimate) or the oldest
        request's ``max_wait_us`` age cap (None if idle)."""
        with self._cond:
            return self.queue.earliest_flush_us(self.cfg.max_wait_us,
                                                self._exec_ewma_us)

    def _trace_begin(self, tracer, r: "ServeRequest") -> None:
        """Open the request's async spans retroactively at its enqueue
        timestamp. Begins are recorded here on the scheduler-side paths
        (dispatch / shed / drain) rather than in ``submit`` so the
        client fast path — 64 threads contending inside ``_cond`` —
        records nothing but an id; every span still carries the exact
        enqueue time the submit path stamped on the request."""
        dl = (None if not math.isfinite(r.deadline_us)
              else r.deadline_us)
        tracer.abegin_nested("request", "queue_wait", r.trace_id,
                             r.t_enqueue_us,
                             args={"lane": r.priority, "rows": r.rows,
                                   "deadline_us": dl})

    def _shed(self, expired: List[ServeRequest], now_us: float) -> None:
        tracer = self.tracer
        for r in expired:
            r.future.t_done_us = now_us
            self.metrics.record_shed(r.priority, now_us=now_us)
            if r.trace_id is not None:
                self._trace_begin(tracer, r)
                tracer.aend("queue_wait", r.trace_id,
                            args={"flush_reason": "shed"})
                tracer.aend("request", r.trace_id,
                            args={"outcome": "shed", "lane": r.priority})
            r.future.set_exception(RequestRejected(
                RejectReason.DEADLINE_EXCEEDED,
                f"deadline missed by {now_us - r.deadline_us:.1f} µs "
                f"before dispatch (lane {r.priority})"))

    def _due_batch(self, now_us: float, force: bool
                   ) -> Tuple[List[ServeRequest], List[ServeRequest], str]:
        """(expired-to-shed, batch-to-run, flush-reason) at ``now_us``.
        Expired requests are always removed — on the forced shutdown
        drain too, a late result is still a wrong result.

        The flush reason records *which* trigger fired: ``size`` (the
        batch is row-full), ``max_wait`` (oldest request hit the age
        cap), ``deadline`` (tightest SLO deadline minus the execution
        estimate), ``drain`` (forced flush). Size wins ties — it is the
        trigger that would have fired regardless of time."""
        with self._cond:
            expired = self.queue.shed_expired(now_us)
            if len(self.queue) == 0:
                return expired, [], ""
            full = self.queue.rows >= self.cfg.max_batch
            oldest = self.queue.oldest_enqueue_us()
            age_due = (oldest is not None
                       and now_us >= oldest + self.cfg.max_wait_us)
            flush_at = self.queue.earliest_flush_us(self.cfg.max_wait_us,
                                                    self._exec_ewma_us)
            due = flush_at is not None and now_us >= flush_at
            if not (full or due or force):
                return expired, [], ""
            reason = ("size" if full else
                      "max_wait" if age_due else
                      "deadline" if due else "drain")
            return expired, self.queue.pop_batch(self.cfg.max_batch), reason

    def _run_batch(self, batch: List[ServeRequest],
                   reason: str = "drain") -> None:
        tracer = self.tracer
        rows = sum(r.rows for r in batch)
        t_form = self.clock.now_us()
        if tracer.enabled:
            for r in batch:
                if r.trace_id is not None:
                    # open both spans at the enqueue ts, close the
                    # queue phase at exactly t_form; the flush reason
                    # lives on the batch_form span
                    self._trace_begin(tracer, r)
                    tracer.aend("queue_wait", r.trace_id, ts_us=t_form)
        xs = [r.x if r.x.ndim > 1 else r.x[None] for r in batch]
        tightest = min(r.deadline_us for r in batch)
        xcat = np.concatenate(xs, axis=0) if len(xs) > 1 else xs[0]
        if tracer.enabled:
            # explicit endpoints so batch formation covers everything
            # from t_form (queue_wait ends) through the concat — the
            # per-request close loop and payload staging included;
            # otherwise that work is an unattributed reconciliation gap
            tracer.complete("batch_form", t_form, self.clock.now_us(),
                            cat="batch",
                            args={"flush_reason": reason, "rows": rows,
                                  "n_requests": len(batch)})
        t0 = self.clock.now_us()
        try:
            with tracer.span("exec", cat="exec", args={"rows": rows}):
                if self._pass_deadline:
                    res = self.executor(xcat, deadline_us=tightest)
                else:
                    res = self.executor(xcat)
        except Exception as e:              # fail the whole batch, keep serving
            now = self.clock.now_us()
            self.metrics.record_error(len(batch))
            for r in batch:
                r.future.t_done_us = now
                if r.trace_id is not None:
                    tracer.aend("request", r.trace_id,
                                args={"outcome": "error",
                                      "error": type(e).__name__})
                r.future.set_exception(e)
            return
        now = self.clock.now_us()
        self.metrics.record_batch(rows, now - t0, now_us=now)
        dt = now - t0
        self._n_execs += 1
        self._exec_ewma_us = (dt if self._n_execs == 1
                              and not self._ewma_seeded
                              else 0.8 * self._exec_ewma_us + 0.2 * dt)
        res = np.asarray(res)
        assert res.shape[0] == rows, (
            f"executor returned {res.shape[0]} rows for a {rows}-row batch")
        with tracer.span("scatter", cat="sched",
                         args={"n_requests": len(batch)}):
            off = 0
            for r in batch:
                out = res[off: off + r.rows]
                off += r.rows
                r.future.t_done_us = now
                self.metrics.record_done(now - r.t_enqueue_us, now,
                                         lane=r.priority,
                                         deadline_us=r.deadline_us)
                if r.trace_id is not None:
                    tracer.aend("request", r.trace_id, args={
                        "outcome": "ok",
                        "latency_us": now - r.t_enqueue_us})
                r.future.set_result(out[0] if r.x.ndim <= 1 else out)

    def poll(self, now_us: Optional[float] = None, force: bool = False) -> int:
        """Run every batch due at ``now_us`` (clock-now if omitted);
        ``force`` flushes regardless of deadlines. Returns requests
        resolved — completed, shed past-deadline, or failed with the
        executor's error."""
        done = 0
        while True:
            now = self.clock.now_us() if now_us is None else now_us
            expired, batch, reason = self._due_batch(now, force)
            self._shed(expired, now)
            done += len(expired)
            if not batch:
                if expired:
                    continue        # shedding may have exposed a due batch
                return done
            self._run_batch(batch, reason)
            done += len(batch)

    def drain(self) -> int:
        """Synchronously flush everything queued (partial batches too);
        already-expired requests are shed, not served late."""
        return self.poll(force=True)

    def pending(self) -> int:
        with self._cond:
            return len(self.queue)

    # -- threaded driver ---------------------------------------------------
    def start(self) -> "MicroBatchScheduler":
        assert self._thread is None, "scheduler already started"
        with self._cond:
            self._stopping = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="microbatch-sched")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while True:
            with self._cond:
                while (not self._stopping and len(self.queue) == 0):
                    self._cond.wait(timeout=0.05)
                if self._stopping and len(self.queue) == 0:
                    return
                now = self.clock.now_us()
                full = self.queue.rows >= self.cfg.max_batch
                flush_at = self.queue.earliest_flush_us(
                    self.cfg.max_wait_us, self._exec_ewma_us)
                wait_us = (0.0 if full or flush_at is None or self._stopping
                           else flush_at - now)
                if wait_us > 0:
                    self._cond.wait(timeout=wait_us * 1e-6)
                    continue
                stopping = self._stopping   # snapshot under the lock
            self.poll(force=stopping)

    def stop(self, drain: bool = True) -> None:
        """Stop the driver thread, reject all further submissions, then
        resolve what is queued (flush by default, typed shutdown-reject
        with ``drain=False``).

        Shutdown is latched *before* the final flush: a submit racing
        with ``stop`` gets a typed ``RequestRejected(SHUTDOWN)`` instead
        of being accepted into a queue nobody will ever serve again (the
        old order accepted it after the drain and its future hung
        forever).
        """
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        with self._cond:
            self._shutdown = True       # latch before the final flush
        if drain:
            self.drain()
        now = self.clock.now_us()
        with self._cond:
            leftovers = self.queue.pop_all()
        for r in leftovers:             # drain=False (or raced remnants)
            r.future.t_done_us = now
            self.metrics.record_reject(RejectReason.SHUTDOWN)
            if r.trace_id is not None:
                self._trace_begin(self.tracer, r)
                self.tracer.aend("queue_wait", r.trace_id,
                                 args={"flush_reason": "drain"})
                self.tracer.aend("request", r.trace_id,
                                 args={"outcome": "shutdown"})
            r.future.set_exception(RequestRejected(
                RejectReason.SHUTDOWN, "scheduler stopped before dispatch"))
