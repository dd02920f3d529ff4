"""Append-only perf-trajectory ledger across the port's benchmark runs,
the twin of the reference's ``benchmarks/history.py`` (the same ledger
format, idempotent appends, trajectory and report).

``check_regression`` answers "did this PR regress vs HEAD?" — a
two-point diff. This module keeps the whole trajectory: every
``BENCH_<section>_torch.json`` appended here becomes one ledger entry
keyed by its ``meta`` provenance block (git sha, UTC timestamp,
device), so "when did p95 start creeping?" is answerable from the repo
itself.

Ledger format: JSONL at ``build/bench/history_torch.jsonl`` (``build/``
is not committed), one entry per (section, run) —

    {"section": "serve", "meta": {...bench_meta...},
     "metrics": {"serve/bitplane/open_loop/qps": [183422.0, "higher"],
                 ...}}

Entries are flattened through ``check_regression.extract_metrics`` so
the ledger stores exactly the direction-aware metric set the
regression gate diffs — the two tools agree on what a "metric" is by
construction. Appends are idempotent per (section, git_sha,
timestamp): re-running a step never duplicates an entry.

  python -m repro_torch.bench.history append BENCH_serve_torch.json
  python -m repro_torch.bench.history report --section serve --last 20
  python -m repro_torch.bench.history report \
      --metric serve/sequential/p95_us
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

from repro_torch.bench.check_regression import LOWER, extract_metrics
from repro_torch.bench.meta import REPO_ROOT

DEFAULT_LEDGER = os.path.join(REPO_ROOT, "build", "bench",
                              "history_torch.jsonl")

SPARK = "▁▂▃▄▅▆▇█"


def _entry_key(entry: Dict) -> tuple:
    meta = entry.get("meta") or {}
    return (entry.get("section"), meta.get("git_sha"),
            meta.get("timestamp_utc"))


def load_history(path: str = DEFAULT_LEDGER) -> List[Dict]:
    """All ledger entries in append order; unparsable lines are skipped
    (a half-written line from a killed job must not poison every later
    report)."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def append_entry(doc: Dict, path: str = DEFAULT_LEDGER) -> Optional[Dict]:
    """Append one BENCH json's metrics to the ledger.

    Returns the entry written, or None when an entry with the same
    (section, git sha, timestamp) provenance already exists — appends
    are idempotent so a retried job cannot double-count a run."""
    entry = {
        "section": doc.get("section", "?"),
        "meta": doc.get("meta") or {},
        "metrics": {name: [value, direction]
                    for name, (value, direction)
                    in sorted(extract_metrics(doc).items())},
    }
    if not entry["metrics"]:
        return None
    key = _entry_key(entry)
    if any(_entry_key(e) == key for e in load_history(path)):
        return None
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(entry, default=str) + "\n")
    return entry


def append_file(bench_path: str, path: str = DEFAULT_LEDGER
                ) -> Optional[Dict]:
    with open(bench_path) as f:
        return append_entry(json.load(f), path=path)


def _spark(values: List[float]) -> str:
    lo, hi = min(values), max(values)
    if hi <= lo:
        return SPARK[0] * len(values)
    return "".join(
        SPARK[int((v - lo) / (hi - lo) * (len(SPARK) - 1))] for v in values)


def trajectory(entries: List[Dict], section: Optional[str] = None,
               metric: Optional[str] = None, last: int = 0) -> Dict:
    """Per-metric trajectory over the ledger: ordered points plus
    first/last/best/worst and the direction-aware net change (positive
    ``change_pct`` always means "got worse")."""
    series: Dict[str, Dict] = {}
    for e in entries:
        if section and e.get("section") != section:
            continue
        meta = e.get("meta") or {}
        sha = (meta.get("git_sha") or "?")[:9]
        ts = meta.get("timestamp_utc")
        for name, (value, direction) in (e.get("metrics") or {}).items():
            if metric and name != metric:
                continue
            s = series.setdefault(name, {"direction": direction,
                                         "points": []})
            s["points"].append({"value": float(value), "git_sha": sha,
                                "timestamp_utc": ts})
    for name, s in series.items():
        pts = s["points"][-last:] if last else s["points"]
        s["points"] = pts
        vals = [p["value"] for p in pts]
        lower = s["direction"] == LOWER
        s["n"] = len(vals)
        s["first"], s["last"] = vals[0], vals[-1]
        s["best"] = min(vals) if lower else max(vals)
        s["worst"] = max(vals) if lower else min(vals)
        delta = vals[-1] - vals[0]
        worse = delta if lower else -delta
        s["change_pct"] = (100.0 * worse / abs(vals[0])
                           if vals[0] else 0.0)
    return series


def format_report(series: Dict, threshold_pct: float = 10.0) -> str:
    if not series:
        return "[history] ledger empty — nothing to report"
    lines = [f"perf trajectory ({max(s['n'] for s in series.values())} "
             "run(s) in ledger):",
             f"  {'metric':<44}{'n':>4}{'first':>12}{'last':>12}"
             f"{'net':>9}  trend"]
    for name in sorted(series):
        s = series[name]
        flag = ("  <-- drifting" if s["change_pct"] > threshold_pct
                else "")
        lines.append(
            f"  {name:<44}{s['n']:>4}{s['first']:>12.1f}"
            f"{s['last']:>12.1f}{s['change_pct']:>+8.1f}%  "
            f"{_spark([p['value'] for p in s['points']])}{flag}")
    lines.append("  (net > 0 = worse in that metric's direction; "
                 "trend bars low->high by raw value)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="append-only benchmark-trajectory ledger")
    ap.add_argument("--ledger", default=DEFAULT_LEDGER,
                    help="ledger path (default build/bench/"
                         "history_torch.jsonl)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_app = sub.add_parser("append",
                           help="append BENCH_*.json file(s) to the ledger")
    p_app.add_argument("files", nargs="+")
    p_rep = sub.add_parser("report", help="print the trajectory report")
    p_rep.add_argument("--section", default=None)
    p_rep.add_argument("--metric", default=None)
    p_rep.add_argument("--last", type=int, default=0,
                       help="only the most recent N runs per metric")
    p_rep.add_argument("--json", action="store_true",
                       help="machine-readable trajectory instead of text")
    p_rep.add_argument("--threshold-pct", type=float, default=10.0,
                       help="flag metrics whose net change is worse than "
                            "this percentage")
    args = ap.parse_args(argv)

    if args.cmd == "append":
        for name in args.files:
            if not os.path.exists(name):
                print(f"[history] {name}: missing — skipped")
                continue
            try:
                entry = append_file(name, path=args.ledger)
            except (json.JSONDecodeError, OSError) as e:
                print(f"[history] ERROR: cannot append {name}: {e}")
                return 2
            if entry is None:
                print(f"[history] {name}: duplicate provenance or no "
                      "metrics — skipped")
            else:
                print(f"[history] {name}: appended "
                      f"{len(entry['metrics'])} metric(s) "
                      f"@ {(entry['meta'].get('git_sha') or '?')[:9]}")
        return 0

    series = trajectory(load_history(args.ledger), section=args.section,
                        metric=args.metric, last=args.last)
    if args.json:
        print(json.dumps(series, indent=1, default=str))
    else:
        print(format_report(series, threshold_pct=args.threshold_pct))
    return 0


if __name__ == "__main__":
    sys.exit(main())
