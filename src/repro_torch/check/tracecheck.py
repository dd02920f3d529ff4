"""Pass 6 — trace-schema validation over ``repro_torch.obs`` traces.

A trace is only useful evidence if its invariants hold, so this pass
gates the properties downstream analysis leans on:

  * **phase vocabulary** — every event is one of ``X`` (thread span),
    ``b``/``n``/``e`` (async begin/instant/end) or ``i`` (instant);
  * **span times** — ``X`` spans have ``dur_us >= 0`` and finite
    timestamps, and same-thread spans properly nest or are disjoint
    (lexical ``with tracer.span()`` nesting guarantees time
    containment — a partial overlap means a clock or threading bug);
  * **async pairing** — per ``(cat, scope_id)``, begin/end events pair
    LIFO in recording order (``b request``, ``b queue_wait``,
    ``e queue_wait``, ``e request``) with scope-local timestamps
    non-decreasing. Ends without a begin and begins without an end are
    orphans. Scope ids that never open a span are *legal*: admission
    rejects allocate a trace id but record only an ``i reject``
    instant, never an async begin;
  * **flush reasons** — any ``flush_reason`` arg must come from
    ``repro_torch.obs.trace.FLUSH_REASONS``;
  * **terminal outcomes** — every ``e request`` must state how the
    request ended (``ok``/``shed``/``error``/``shutdown``).

Pairing violations downgrade to warnings when the source ring buffer
dropped events (``n_dropped > 0``): a truncated trace legitimately
loses begins — raise the tracer capacity rather than fail the check.

Ordering caveat baked into the rules: ``X`` spans are recorded at
context *exit*, so an ``e request`` async end lands in the buffer
before the ``X scatter`` span that contains it. Async pairing is
therefore checked in buffer order, thread-span nesting by time — never
across the two families.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from .report import CheckReport

PASS = "trace"

VALID_PH = ("X", "b", "n", "e", "i")
TERMINAL_OUTCOMES = ("ok", "shed", "error", "shutdown")


def _flush_reasons() -> Tuple[str, ...]:
    from repro_torch.obs.trace import FLUSH_REASONS
    return FLUSH_REASONS


def check_trace(events: Iterable, n_dropped: int = 0,
                report: Optional[CheckReport] = None) -> CheckReport:
    """Validate a sequence of ``TraceEvent`` records (from
    ``SpanTracer.events()`` or ``repro_torch.obs.load_trace_events``)."""
    rep = report if report is not None else CheckReport("trace")
    evs = list(events)
    reasons = _flush_reasons()
    truncated = n_dropped > 0

    def pairing_issue(code: str, msg: str, where: str) -> None:
        if truncated:
            rep.warn(PASS, code, msg + " (ring buffer dropped "
                     f"{n_dropped} events; raise tracer capacity)", where)
        else:
            rep.error(PASS, code, msg, where)

    # per-thread X spans for the nesting sweep; per-scope async stacks
    by_tid: Dict[int, List] = {}
    open_spans: Dict[Tuple[str, Optional[int]], List[str]] = {}
    last_ts: Dict[Tuple[str, Optional[int]], float] = {}

    for idx, ev in enumerate(evs):
        where = f"event {idx} ({ev.ph} {ev.name!r})"
        if ev.ph not in VALID_PH:
            rep.error(PASS, "bad-phase",
                      f"unknown phase {ev.ph!r} (valid: {VALID_PH})", where)
            continue
        if not (ev.ts_us == ev.ts_us and abs(ev.ts_us) != float("inf")):
            rep.error(PASS, "bad-timestamp",
                      f"non-finite timestamp {ev.ts_us!r}", where)
            continue
        if ev.args and "flush_reason" in ev.args \
                and ev.args["flush_reason"] not in reasons:
            rep.error(PASS, "bad-flush-reason",
                      f"flush_reason {ev.args['flush_reason']!r} not in "
                      f"{reasons}", where)
        rep.checked += 1

        if ev.ph == "X":
            if ev.dur_us < 0:
                rep.error(PASS, "negative-dur",
                          f"negative duration {ev.dur_us} us", where)
            else:
                by_tid.setdefault(ev.tid, []).append(ev)
            continue
        if ev.ph == "i":
            continue

        # async events: LIFO pairing per (cat, scope_id) in buffer order
        key = (ev.cat, ev.scope_id)
        if ev.scope_id is None:
            rep.error(PASS, "missing-scope",
                      "async event without a scope id", where)
            continue
        if key in last_ts and ev.ts_us < last_ts[key]:
            rep.error(PASS, "time-regression",
                      f"scope {ev.scope_id} time went backwards "
                      f"({last_ts[key]} -> {ev.ts_us} us)", where)
        last_ts[key] = ev.ts_us
        stack = open_spans.setdefault(key, [])
        if ev.ph == "b":
            stack.append(ev.name)
        elif ev.ph == "n":
            if not stack:
                rep.warn(PASS, "instant-outside-span",
                         f"async instant on scope {ev.scope_id} with no "
                         "open span", where)
        else:                            # "e"
            if not stack:
                pairing_issue("orphan-end",
                              f"end without begin on scope {ev.scope_id}",
                              where)
            elif stack[-1] != ev.name:
                rep.error(PASS, "end-mismatch",
                          f"end {ev.name!r} but innermost open span on "
                          f"scope {ev.scope_id} is {stack[-1]!r}", where)
                if ev.name in stack:     # resync so one slip != cascade
                    del stack[stack.index(ev.name):]
            else:
                stack.pop()
            if ev.name == "request":
                outcome = (ev.args or {}).get("outcome")
                if outcome not in TERMINAL_OUTCOMES:
                    rep.error(PASS, "bad-outcome",
                              f"request end outcome {outcome!r} not in "
                              f"{TERMINAL_OUTCOMES}", where)

    for (cat, sid), stack in open_spans.items():
        if stack:
            pairing_issue("unterminated-span",
                          f"scope {sid} ({cat}) left open: {stack}",
                          f"scope {sid}")

    # thread-span nesting: same-tid spans must nest or be disjoint
    for tid, spans in by_tid.items():
        spans.sort(key=lambda e: (e.ts_us, -e.dur_us))
        stack: List = []
        for ev in spans:
            end = ev.ts_us + ev.dur_us
            while stack and ev.ts_us >= stack[-1].ts_us + stack[-1].dur_us:
                stack.pop()
            if stack and end > stack[-1].ts_us + stack[-1].dur_us:
                outer = stack[-1]
                rep.error(PASS, "span-overlap",
                          f"{ev.name!r} [{ev.ts_us}, {end}] partially "
                          f"overlaps {outer.name!r} "
                          f"[{outer.ts_us}, "
                          f"{outer.ts_us + outer.dur_us}] on tid {tid}",
                          f"tid {tid}")
            stack.append(ev)
            rep.checked += 1

    rep.info["events"] = len(evs)
    rep.info["n_dropped"] = int(n_dropped)
    return rep


def check_phase_reconciliation(events: Iterable, n_dropped: int = 0,
                               tol: float = None,
                               report: Optional[CheckReport] = None
                               ) -> CheckReport:
    """Validate the phase-reconciliation invariant over a trace: for
    every completed (``outcome == "ok"``) request, the attributed phase
    times must account for its end-to-end latency —

        ``queue_wait + batch_form + exec ~= latency_us``

    within the analyzer tolerance (``repro_torch.obs.analyze.DEFAULT_TOL``).
    A request whose phases do not sum to its latency means a span is
    missing, double-counted, or stamped with the wrong clock — the
    trace can no longer answer "where did the time go". Downgraded to a
    warning when the ring buffer dropped events (a truncated trace
    legitimately loses the spans the sum needs), or while the trace as
    a whole stays within the analyzer's straggler allowance (an OS
    preemption between two clock stamps inflates one request's gap;
    a real mis-attribution shows up across every request)."""
    from repro_torch.obs.analyze import DEFAULT_TOL, analyze_events
    rep = report if report is not None else CheckReport("trace")
    tol = DEFAULT_TOL if tol is None else tol
    truncated = n_dropped > 0

    rpt = analyze_events(events, tol=tol)
    recon = rpt.reconciliation()
    rep.checked += recon["n_checked"]
    rep.info["phase_recon"] = recon
    if recon["n_checked"] == 0:
        if not truncated and rpt.requests:
            rep.warn(PASS, "phase-recon-empty",
                     f"{len(rpt.requests)} request(s) in trace but none "
                     "completed ok — reconciliation not checkable",
                     "phase reconciliation")
        return rep
    for r in rpt.requests:
        if r.outcome != "ok":
            continue
        err = r.recon_error()
        if err is None or err <= tol:
            continue
        attributed = r.wait_us + r.batch.form_us + r.batch.exec_us
        msg = (f"request {r.sid}: phases sum to {attributed:.1f} us "
               f"but latency is {r.latency_us:.1f} us "
               f"({err:.1%} > {tol:.0%} tolerance)")
        if truncated:
            rep.warn(PASS, "phase-reconcile", msg + " (ring buffer "
                     f"dropped {n_dropped} events)", f"request {r.sid}")
        elif recon["ok"]:
            rep.warn(PASS, "phase-reconcile", msg + " (within the "
                     f"{recon['n_allowed']}-straggler allowance)",
                     f"request {r.sid}")
        else:
            rep.error(PASS, "phase-reconcile", msg, f"request {r.sid}")
    return rep


def check_trace_file(path: str,
                     report: Optional[CheckReport] = None) -> CheckReport:
    """Validate an exported trace file (Chrome JSON or JSONL)."""
    from repro_torch.obs.export import load_trace_events
    rep = report if report is not None else CheckReport("trace")
    try:
        events = load_trace_events(path)
    except (OSError, ValueError, KeyError) as e:
        rep.error(PASS, "unreadable",
                  f"cannot parse trace file: {e}", path)
        return rep
    if not events:
        rep.warn(PASS, "empty-trace", "trace file contains no events",
                 path)
    rep.info["file"] = path
    check_trace(events, report=rep)
    return check_phase_reconciliation(events, report=rep)


def synthetic_trace_events() -> Tuple[List, int]:
    """Drive a FakeClock scheduler through every lifecycle edge — size
    flush, max-wait flush, expiry shed, admission reject, drain — and
    return ``(events, n_dropped)``. The ``--passes trace`` fallback
    when no ``--trace-file`` is given: validates the *live*
    instrumentation, not a canned fixture."""
    import numpy as np

    from repro_torch.obs.trace import SpanTracer
    from repro_torch.serve import (MicroBatchScheduler, RequestRejected,
                             SchedConfig, FakeClock)

    clk = FakeClock()
    tracer = SpanTracer(clock=clk, capacity=4096)
    s = MicroBatchScheduler(
        lambda x: x.sum(axis=-1),
        SchedConfig(max_batch=4, max_wait_us=200.0, max_queue=8,
                    n_priorities=1, lane_slo_us=(1000.0,)),
        clock=clk, tracer=tracer)
    futs = [s.submit(np.full((1, 3), i, np.float32)) for i in range(4)]
    s.poll()                             # size flush
    futs.append(s.submit(np.ones((2, 3), np.float32)))
    clk.advance_us(250.0)
    s.poll()                             # max-wait flush
    futs.append(s.submit(np.ones((1, 3), np.float32)))
    clk.advance_us(1500.0)               # past the lane SLO
    try:
        s.submit(np.ones((9, 3), np.float32))   # rows > max_batch
    except RequestRejected:
        pass
    s.drain()                            # expiry shed for the stale one
    for f in futs:
        try:
            f.result(0)
        except RequestRejected:
            pass
    return tracer.events(), tracer.n_dropped
