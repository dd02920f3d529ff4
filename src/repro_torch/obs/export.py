"""Trace export: Chrome trace-event JSON (Perfetto-loadable) + JSONL.

The Chrome JSON Object Format (the ``{"traceEvents": [...]}`` shape)
opens directly in https://ui.perfetto.dev or chrome://tracing. Thread
spans map to complete events (``ph="X"``), per-request lifecycles map
to async events (``ph="b"/"n"/"e"``, keyed by the request's trace id)
so each request renders as its own track with submit → queue →
batch-formed → complete milestones, overlapping freely with other
requests. ``otherData`` carries the metrics-registry snapshot when one
is supplied, so a trace file is a self-contained incident report.

JSONL export writes one structured event per line — the grep/pandas
surface for scripted analysis where a timeline viewer is overkill.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Union

from .trace import TraceEvent

_EVENT_SOURCE = Union["SpanTracer", Iterable[TraceEvent]]  # noqa: F821


def _as_events(src) -> List[TraceEvent]:
    if hasattr(src, "events"):
        return list(src.events())
    return list(src)


def to_chrome_trace(src, pid: int = 1,
                    process_name: str = "repro_torch.serve",
                    other_data: Optional[Dict] = None) -> Dict:
    """Events -> Chrome JSON Object Format dict.

    Times are emitted in µs directly (the Chrome format's native unit),
    so FakeClock timestamps round-trip exactly."""
    out: List[Dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    tids = {}
    for ev in _as_events(src):
        tid = tids.setdefault(ev.tid, len(tids) + 1)   # compact tids
        rec: Dict = {"name": ev.name, "cat": ev.cat, "ph": ev.ph,
                     "ts": ev.ts_us, "pid": pid, "tid": tid}
        if ev.ph == "X":
            rec["dur"] = ev.dur_us
        if ev.scope_id is not None:
            rec["id"] = str(ev.scope_id)
        if ev.args:
            rec["args"] = dict(ev.args)
        out.append(rec)
    doc: Dict = {"traceEvents": out, "displayTimeUnit": "ns"}
    if other_data is not None:
        doc["otherData"] = other_data
    return doc


def write_chrome_trace(path: str, src, pid: int = 1,
                       process_name: str = "repro_torch.serve",
                       other_data: Optional[Dict] = None) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(src, pid=pid, process_name=process_name,
                                  other_data=other_data), f)
    return path


def to_jsonl(src) -> str:
    lines = []
    for ev in _as_events(src):
        lines.append(json.dumps({
            "ph": ev.ph, "name": ev.name, "cat": ev.cat,
            "ts_us": ev.ts_us, "dur_us": ev.dur_us, "tid": ev.tid,
            "id": ev.scope_id, "args": ev.args or {}}))
    return "\n".join(lines) + ("\n" if lines else "")


def write_jsonl(path: str, src) -> str:
    with open(path, "w") as f:
        f.write(to_jsonl(src))
    return path


def load_trace_events(path: str) -> List[TraceEvent]:
    """Read either export format back into ``TraceEvent`` records
    (metadata events are dropped) — the input side of the trace
    validation pass."""
    with open(path) as f:
        text = f.read()
    events: List[TraceEvent] = []
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
    if isinstance(doc, dict) and "traceEvents" in doc:   # Chrome format
        for rec in doc["traceEvents"]:
            if rec.get("ph") == "M":
                continue
            sid = rec.get("id")
            events.append(TraceEvent(
                rec.get("ph", "?"), rec.get("name", "?"),
                rec.get("cat", "?"), float(rec.get("ts", 0.0)),
                float(rec.get("dur", 0.0)), int(rec.get("tid", 0)),
                None if sid is None else int(sid),
                rec.get("args")))
        return events
    for line in text.splitlines():                        # JSONL
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        events.append(TraceEvent(
            rec["ph"], rec["name"], rec["cat"], float(rec["ts_us"]),
            float(rec.get("dur_us", 0.0)), int(rec.get("tid", 0)),
            rec.get("id"), rec.get("args")))
    return events
