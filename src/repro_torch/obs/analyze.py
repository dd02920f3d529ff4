"""Trace analytics: per-request phase breakdowns from trace artifacts.

``repro_torch.obs.trace`` records *events*; this module turns them back into
*requests* and answers "where did the microseconds go". The
reconstruction leans on two structural facts of the serving stack:

  * async request spans carry a tracer-allocated ``scope_id``, so a
    request's begin/instants/end pair up across threads by id;
  * the scheduler serializes batches on one dispatch thread and thread
    spans record at context *exit*, so each batch appears in buffer
    order as ``[e queue_wait]*n → X batch_form → (X aggregate_pack,
    X device_exec, X replica_dispatch) → X exec → [e request]*n →
    X scatter`` — a linear scan with a current-batch state machine
    rebinds every request to the batch that served it.

Per-request phase decomposition (all µs):

  ``queue_wait``  enqueue → batch formation (per-request, measured)
  ``batch_form``  payload concatenation for the batch it rode
  ``pack``        bitplane aggregation (quantize + scatter to lanes)
  ``device_exec`` netlist evaluation on the engine
  ``dispatch``    executor time not inside pack/device — replica pick,
                  failover, mesh placement (``exec − pack − device``)
  ``scatter``     result slicing back to futures (*after* the latency
                  stamp — reported, but outside the reconciliation sum)

The **reconciliation invariant** — checked here and by
the reference package's ``check --passes trace`` — is that for every completed request
``queue_wait + batch_form + exec`` matches the ``latency_us`` the
scheduler stamped on the request end (the same number ``ServeMetrics``
aggregates) within tolerance: the trace is only trustworthy if its
phases add back up to the latency the serving stack reports.

Ring-buffer truncation is expected, not an error: orphaned ends (their
begins overwritten) still contribute their ``wait_us``/``latency_us``
args where present and are counted in ``truncated``; a zero-request or
shed-only trace produces a report, not a crash.

CLI::

    python -m repro_torch.obs.analyze --trace serve_trace.json
    python -m repro_torch.obs.analyze --trace new.json --diff old.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

from .trace import TraceEvent

# phases inside the reconciliation sum, in pipeline order
RECON_PHASES = ("queue_wait", "batch_form", "pack", "dispatch",
                "device_exec")
ALL_PHASES = RECON_PHASES + ("scatter", "unattributed")

# absolute slop floor (µs) under the relative tolerance: SystemClock
# traces pay a few clock reads between span edges, and the scheduler
# thread can be preempted for tens of µs between two stamps; FakeClock
# traces reconcile exactly
DEFAULT_TOL = 0.05
ABS_FLOOR_US = 50.0
# fraction of checked requests allowed over tolerance before the trace
# as a whole fails reconciliation: a single OS preemption landing
# between two clock reads inflates one request's gap past any floor,
# and that is scheduler noise, not a mis-attributed span (which shows
# up across *every* request in the affected batches)
STRAGGLER_FRAC = 0.005


@dataclasses.dataclass
class BatchRecord:
    """One dispatched batch reconstructed from thread spans."""

    idx: int
    flush_reason: str = ""
    rows: int = 0
    n_requests: int = 0
    form_us: float = 0.0
    pack_us: float = 0.0
    device_us: float = 0.0
    exec_us: float = 0.0
    scatter_us: float = 0.0
    kernel_us: float = 0.0          # lut_eval spans inside device_exec
    members: List[int] = dataclasses.field(default_factory=list)

    @property
    def dispatch_us(self) -> float:
        """Executor time not attributed to pack or device work."""
        return max(0.0, self.exec_us - self.pack_us - self.device_us)


@dataclasses.dataclass
class RequestRecord:
    """One request lifecycle reassembled from its async span."""

    sid: int
    lane: Optional[int] = None
    rows: int = 1
    deadline_us: Optional[float] = None
    t_begin_us: Optional[float] = None
    t_end_us: Optional[float] = None
    wait_us: Optional[float] = None
    flush_reason: Optional[str] = None
    outcome: Optional[str] = None
    latency_us: Optional[float] = None
    batch: Optional[BatchRecord] = None
    truncated: bool = False         # begin lost to the ring buffer

    def phases_us(self) -> Optional[Dict[str, float]]:
        """Per-phase attribution, or None when the request never rode a
        batch (shed/shutdown) or its timing is incomplete."""
        if self.batch is None or self.wait_us is None:
            return None
        b = self.batch
        out = {"queue_wait": self.wait_us, "batch_form": b.form_us,
               "pack": b.pack_us, "dispatch": b.dispatch_us,
               "device_exec": b.device_us, "scatter": b.scatter_us}
        if self.latency_us is not None:
            recon = self.wait_us + b.form_us + b.exec_us
            out["unattributed"] = self.latency_us - recon
        return out

    def recon_error(self) -> Optional[float]:
        """Relative reconciliation error |phase sum − latency| /
        latency, or None when either side is unknown."""
        if (self.batch is None or self.wait_us is None
                or self.latency_us is None or self.latency_us <= 0):
            return None
        recon = self.wait_us + self.batch.form_us + self.batch.exec_us
        gap = abs(recon - self.latency_us)
        if gap <= ABS_FLOOR_US:         # clock-read jitter, not skew
            return 0.0
        return gap / self.latency_us


class TraceReport:
    """Reconstruction product: requests, batches, and derived stats."""

    def __init__(self, requests: List[RequestRecord],
                 batches: List[BatchRecord], n_events: int,
                 counts: Dict[str, int], tol: float = DEFAULT_TOL):
        self.requests = requests
        self.batches = batches
        self.n_events = n_events
        self.counts = counts
        self.tol = tol

    # -- derived -----------------------------------------------------------
    def reconciliation(self) -> Dict:
        errs = [e for r in self.requests
                if r.outcome == "ok" and (e := r.recon_error()) is not None]
        out = {"tol": self.tol, "n_checked": len(errs),
               "mean_rel_err": float(np.mean(errs)) if errs else 0.0,
               "max_rel_err": float(np.max(errs)) if errs else 0.0,
               "n_over_tol": sum(1 for e in errs if e > self.tol),
               "n_allowed": int(STRAGGLER_FRAC * len(errs))}
        out["ok"] = out["n_over_tol"] <= out["n_allowed"]
        return out

    def phase_summary(self) -> Dict[str, Dict[str, float]]:
        """Request-weighted per-phase stats: every request in a batch
        experiences the batch's full phase time, so request-µs per
        phase is what a latency budget should be carved from."""
        cols: Dict[str, List[float]] = {p: [] for p in ALL_PHASES}
        for r in self.requests:
            ph = r.phases_us()
            if ph is None:
                continue
            for p in ALL_PHASES:
                if p in ph:
                    cols[p].append(ph[p])
        out: Dict[str, Dict[str, float]] = {}
        total = sum(sum(v) for p, v in cols.items()
                    if p != "scatter" and v)
        for p, v in cols.items():
            if not v:
                continue
            a = np.asarray(v)
            out[p] = {"total_us": float(a.sum()),
                      "mean_us": float(a.mean()),
                      "p50_us": float(np.percentile(a, 50)),
                      "p99_us": float(np.percentile(a, 99)),
                      "share": (float(a.sum()) / total
                                if total > 0 and p != "scatter" else 0.0)}
        return out

    def lane_summary(self) -> Dict[str, Dict]:
        lanes: Dict[int, List[RequestRecord]] = {}
        for r in self.requests:
            if r.lane is not None:
                lanes.setdefault(r.lane, []).append(r)
        out = {}
        for lane, rs in sorted(lanes.items()):
            lat = np.asarray([r.latency_us for r in rs
                              if r.latency_us is not None] or [0.0])
            n_shed = sum(1 for r in rs if r.outcome == "shed")
            out[str(lane)] = {
                "n": len(rs), "n_shed": n_shed,
                "p50_us": float(np.percentile(lat, 50)),
                "p99_us": float(np.percentile(lat, 99))}
        return out

    def to_dict(self) -> Dict:
        outcomes: Dict[str, int] = {}
        for r in self.requests:
            key = r.outcome or "unterminated"
            outcomes[key] = outcomes.get(key, 0) + 1
        reasons: Dict[str, int] = {}
        for b in self.batches:
            reasons[b.flush_reason] = reasons.get(b.flush_reason, 0) + 1
        kernel = sum(b.kernel_us for b in self.batches)
        return {
            "n_events": self.n_events,
            "n_requests": len(self.requests),
            "n_batches": len(self.batches),
            "n_truncated": sum(1 for r in self.requests if r.truncated),
            "counts": dict(self.counts),
            "outcomes": outcomes,
            "flush_reasons": reasons,
            "phases_us": self.phase_summary(),
            "kernel_us_total": kernel,
            "lanes": self.lane_summary(),
            "reconciliation": self.reconciliation(),
        }


def _arg(ev: TraceEvent, key: str):
    return (ev.args or {}).get(key)


def analyze_events(events: Sequence[TraceEvent],
                   tol: float = DEFAULT_TOL) -> TraceReport:
    """Rebuild requests/batches from events in buffer order."""
    reqs: Dict[int, RequestRecord] = {}
    batches: List[BatchRecord] = []
    pending: List[int] = []         # queue_wait-closed, awaiting batch_form
    current: Optional[BatchRecord] = None
    counts = {"rejects": 0, "failovers": 0, "orphan_ends": 0}

    def req(sid: int) -> RequestRecord:
        r = reqs.get(sid)
        if r is None:
            # end without begin: head of the lifecycle fell off the ring
            r = reqs[sid] = RequestRecord(sid=sid, truncated=True)
        return r

    for ev in events:
        if ev.ph == "b" and ev.name == "request":
            r = reqs.get(ev.scope_id)
            if r is None:
                r = reqs[ev.scope_id] = RequestRecord(sid=ev.scope_id)
            r.t_begin_us = ev.ts_us
            r.lane = _arg(ev, "lane")
            r.rows = _arg(ev, "rows") or 1
            r.deadline_us = _arg(ev, "deadline_us")
        elif ev.ph == "e" and ev.name == "queue_wait":
            if ev.scope_id not in reqs:
                counts["orphan_ends"] += 1
            r = req(ev.scope_id)
            r.flush_reason = _arg(ev, "flush_reason")
            w = _arg(ev, "wait_us")
            if w is not None:
                r.wait_us = float(w)
            elif r.t_begin_us is not None:
                r.wait_us = ev.ts_us - r.t_begin_us
            # drain-flushed requests do ride a batch (stop(drain=True));
            # only sheds never reach batch_form. Shutdown leftovers also
            # tag "drain" with no batch — membership is undone at their
            # request end below.
            if r.flush_reason != "shed":
                pending.append(ev.scope_id)
        elif ev.ph == "e" and ev.name == "request":
            if ev.scope_id not in reqs:
                counts["orphan_ends"] += 1
            r = req(ev.scope_id)
            r.t_end_us = ev.ts_us
            r.outcome = _arg(ev, "outcome")
            lat = _arg(ev, "latency_us")
            if lat is not None:
                r.latency_us = float(lat)
            elif r.t_begin_us is not None:
                r.latency_us = ev.ts_us - r.t_begin_us
            if r.outcome in ("shed", "shutdown"):
                r.batch = None      # never dispatched
                if ev.scope_id in pending:
                    pending.remove(ev.scope_id)
        elif ev.ph == "X":
            if ev.name == "batch_form":
                current = BatchRecord(
                    idx=len(batches),
                    flush_reason=_arg(ev, "flush_reason") or "",
                    rows=_arg(ev, "rows") or 0,
                    n_requests=_arg(ev, "n_requests") or 0,
                    form_us=ev.dur_us, members=pending)
                for sid in pending:
                    reqs[sid].batch = current
                pending = []
                batches.append(current)
            elif current is not None and ev.name == "aggregate_pack":
                current.pack_us += ev.dur_us
            elif current is not None and ev.name == "device_exec":
                current.device_us += ev.dur_us
            elif current is not None and ev.name == "exec" \
                    and ev.cat == "exec":
                current.exec_us += ev.dur_us
            elif current is not None and ev.name == "scatter":
                current.scatter_us += ev.dur_us
            elif current is not None and ev.cat == "kernel":
                current.kernel_us += ev.dur_us
        elif ev.ph == "i":
            if ev.name == "reject":
                counts["rejects"] += 1
            elif ev.name == "replica_failover":
                counts["failovers"] += 1

    return TraceReport(list(reqs.values()), batches, len(events),
                       counts, tol=tol)


def analyze_trace(path: str, tol: float = DEFAULT_TOL) -> TraceReport:
    """Load a Chrome-trace/JSONL artifact and analyze it."""
    from .export import load_trace_events
    return analyze_events(load_trace_events(path), tol=tol)


# ---------------------------------------------------------------------------
# Rendering + diff
# ---------------------------------------------------------------------------

def format_report(rep: TraceReport) -> str:
    d = rep.to_dict()
    lines = [
        f"trace: {d['n_events']} events, {d['n_requests']} requests, "
        f"{d['n_batches']} batches"
        + (f", {d['n_truncated']} truncated lifecycles"
           if d["n_truncated"] else ""),
        "outcomes: " + (", ".join(
            f"{k}={v}" for k, v in sorted(d["outcomes"].items())) or "none"),
        "flush reasons: " + (", ".join(
            f"{k}={v}" for k, v in sorted(d["flush_reasons"].items()))
            or "none"),
    ]
    if d["counts"]["rejects"] or d["counts"]["failovers"]:
        lines.append(f"admission rejects: {d['counts']['rejects']}, "
                     f"replica failovers: {d['counts']['failovers']}")
    ph = d["phases_us"]
    if ph:
        lines.append("")
        lines.append("where did the time go (request-weighted, µs):")
        lines.append(f"  {'phase':<14}{'share':>7}{'mean':>12}"
                     f"{'p50':>12}{'p99':>12}{'total':>14}")
        for p in ALL_PHASES:
            if p not in ph:
                continue
            s = ph[p]
            share = (f"{100 * s['share']:.1f}%"
                     if p not in ("scatter",) else "post")
            lines.append(
                f"  {p:<14}{share:>7}{s['mean_us']:>12.1f}"
                f"{s['p50_us']:>12.1f}{s['p99_us']:>12.1f}"
                f"{s['total_us']:>14.1f}")
    if d["lanes"]:
        lines.append("")
        lines.append("per-lane latency (µs):")
        for lane, s in d["lanes"].items():
            lines.append(f"  lane {lane}: n={s['n']} shed={s['n_shed']} "
                         f"p50={s['p50_us']:.1f} p99={s['p99_us']:.1f}")
    rec = d["reconciliation"]
    lines.append("")
    if rec["n_checked"]:
        lines.append(
            f"reconciliation: {rec['n_checked']} requests checked, "
            f"mean err {100 * rec['mean_rel_err']:.2f}%, max "
            f"{100 * rec['max_rel_err']:.2f}%, "
            f"{rec['n_over_tol']}/{rec['n_allowed']} straggler(s) "
            f"({'OK' if rec['ok'] else 'OVER TOLERANCE'} at "
            f"{100 * rec['tol']:.0f}%)")
    else:
        lines.append("reconciliation: no completed requests to check")
    return "\n".join(lines)


def diff_reports(new: TraceReport, old: TraceReport) -> Dict:
    """Phase-level regression attribution between two traces: which
    phase's mean moved, by how much, and in which direction."""
    a, b = new.phase_summary(), old.phase_summary()
    out: Dict = {"phases": {}, "n_requests": {
        "new": len(new.requests), "old": len(old.requests)}}
    for p in ALL_PHASES:
        if p not in a or p not in b:
            continue
        mn, mo = a[p]["mean_us"], b[p]["mean_us"]
        delta = mn - mo
        pct = (delta / mo * 100.0) if mo > 0 else (math.inf if delta > 0
                                                   else 0.0)
        out["phases"][p] = {
            "new_mean_us": mn, "old_mean_us": mo,
            "delta_us": delta, "delta_pct": pct,
            "direction": ("regressed" if delta > 0 else
                          "improved" if delta < 0 else "flat")}
    worst = max(out["phases"].items(),
                key=lambda kv: kv[1]["delta_us"], default=None)
    out["attribution"] = (worst[0] if worst and worst[1]["delta_us"] > 0
                          else None)
    return out


def format_diff(d: Dict) -> str:
    lines = [f"trace diff (new {d['n_requests']['new']} vs old "
             f"{d['n_requests']['old']} requests):",
             f"  {'phase':<14}{'old mean':>12}{'new mean':>12}"
             f"{'delta':>12}{'change':>10}"]
    for p in ALL_PHASES:
        if p not in d["phases"]:
            continue
        s = d["phases"][p]
        pct = ("+inf" if math.isinf(s["delta_pct"])
               else f"{s['delta_pct']:+.1f}%")
        lines.append(f"  {p:<14}{s['old_mean_us']:>12.1f}"
                     f"{s['new_mean_us']:>12.1f}{s['delta_us']:>+12.1f}"
                     f"{pct:>10}")
    if d["attribution"]:
        lines.append(f"largest regression: {d['attribution']}")
    else:
        lines.append("no phase regressed")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.analyze",
        description="Per-request phase breakdown from a serve trace "
                    "(Chrome-trace JSON or JSONL)")
    ap.add_argument("--trace", required=True,
                    help="trace artifact from --trace on launch.serve "
                         "or repro_torch.bench.loadgen")
    ap.add_argument("--diff", default=None, metavar="OLD_TRACE",
                    help="also diff against an older trace for "
                         "regression attribution")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of text")
    ap.add_argument("--tol", type=float, default=DEFAULT_TOL,
                    help="reconciliation tolerance (default 0.05)")
    args = ap.parse_args(argv)

    rep = analyze_trace(args.trace, tol=args.tol)
    if args.diff:
        d = diff_reports(rep, analyze_trace(args.diff, tol=args.tol))
        print(json.dumps({"report": rep.to_dict(), "diff": d}, indent=2)
              if args.json else
              format_report(rep) + "\n\n" + format_diff(d))
    else:
        print(json.dumps(rep.to_dict(), indent=2) if args.json
              else format_report(rep))
    return 0 if rep.reconciliation()["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
