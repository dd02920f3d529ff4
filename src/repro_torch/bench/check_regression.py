"""Benchmark-regression gate of the port, the twin of the reference's
``benchmarks/check_regression.py`` (the same metrics, comparison, drift
normalization, exit codes and messages) over the port's records.

Diffs freshly written ``BENCH_<section>_torch.json`` files (written by
``python -m repro_torch.bench.run``) against committed
baselines and fails when any shared metric regresses past the
tolerance. Baselines default to the versions at git ``HEAD`` — in CI
that is the checked-out commit, i.e. the files *before* the smoke
benchmark steps overwrote them, so no copy step is needed.

Direction-aware comparison:
  * lower-is-better (µs latencies): fail when
    ``fresh > baseline * (1 + tolerance)``;
  * higher-is-better (qps, speedup ratios): fail when
    ``fresh < baseline / (1 + tolerance)``.

Two measures keep the gate honest across machines (a CI runner is not
the dev box that committed the baseline):

  * **Load-amplified metrics are excluded.** Open-loop queueing
    latencies explode non-linearly with the offered-rate/capacity
    ratio, which is machine-relative — a no-op commit on a slower
    runner can show 30x p95. Open-loop records contribute only their
    throughput metrics (qps and the machine-normalized
    ``throughput_x_sequential``); closed-loop and sequential-baseline
    latencies, which scale ~linearly with machine speed, stay in.
  * **Median drift normalization.** Per file, the median ratio across
    shared metrics estimates the uniform machine-speed factor; each
    metric is judged on its residual from that median (clamped to
    ``--max-drift`` so a genuine across-the-board regression bigger
    than the clamp still fails). ``--no-normalize`` compares raw
    ratios.

Metrics present on only one side are reported but never fail the gate
(smoke runs cover a subset of the full benchmark matrix, and new
kernels add rows the old baseline lacks). Sub-floor latencies
(``--min-us``) are skipped: timer noise dominates there.

  python -m repro_torch.bench.check_regression                # HEAD
  python -m repro_torch.bench.check_regression --tolerance 0.5
  python -m repro_torch.bench.check_regression --baseline-dir DIR
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from statistics import median
from typing import Dict, Optional, Tuple

from repro_torch.bench.meta import REPO_ROOT

DEFAULT_FILES = ("BENCH_kernels_torch.json", "BENCH_serve_torch.json")

LOWER, HIGHER = "lower", "higher"        # which direction is better

_LAT_KEYS = (("p50_us", LOWER), ("p95_us", LOWER), ("p99_us", LOWER),
             ("mean_us", LOWER))
_THROUGHPUT_KEYS = (("qps", HIGHER), ("throughput_x_sequential", HIGHER))
# deadline-miss-rate is lower-is-better; SLO attainment is its
# complement. Both are load-normalized fractions, so unlike open-loop
# queueing latencies they are comparable across machine speeds.
_SLO_KEYS = (("deadline_miss_rate", LOWER), ("slo_attainment", HIGHER))


class BaselineError(Exception):
    """A baseline exists but cannot be used (unparsable, or git itself
    is unavailable). Distinct from a *missing* baseline, which is a
    normal skip (new benchmark file); this one needs a human and fails
    the run with an actionable message instead of a traceback."""


def load_baseline(name: str, baseline_dir: Optional[str]) -> Optional[dict]:
    """Baseline JSON from a directory, or from the committed tree at
    git HEAD when no directory is given.

    Returns None when no baseline exists (legitimately skippable);
    raises ``BaselineError`` when one exists but is unusable."""
    if baseline_dir:
        path = os.path.join(baseline_dir, name)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except json.JSONDecodeError as e:
            raise BaselineError(
                f"baseline {path} is not valid JSON ({e}). Re-generate "
                f"it (python -m repro_torch.bench.run --fast) or remove it "
                f"from --baseline-dir to skip this file.")
    try:
        proc = subprocess.run(["git", "show", f"HEAD:{name}"],
                              cwd=REPO_ROOT, capture_output=True)
    except FileNotFoundError:
        raise BaselineError(
            "git is not available, so baselines at HEAD cannot be read. "
            "Pass --baseline-dir pointing at a directory of committed "
            "BENCH_*.json files instead.")
    if proc.returncode != 0:
        # not in the committed tree: a brand-new benchmark file
        return None
    try:
        return json.loads(proc.stdout)
    except json.JSONDecodeError as e:
        raise BaselineError(
            f"baseline {name} at git HEAD is not valid JSON ({e}). The "
            f"committed file is corrupt — re-run the benchmark "
            f"(python -m repro_torch.bench.run --fast) and commit a valid "
            f"{name}, or pass --baseline-dir with a good copy.")


def extract_metrics(doc: dict) -> Dict[str, Tuple[float, str]]:
    """Flatten a BENCH json into {metric_name: (value, direction)}.

    Works on both writers: ``repro_torch.bench.run`` (rows + results)
    and ``repro_torch.bench.loadgen`` (results only) — serve metrics
    always come from ``results`` so the two formats share keys. Only
    ``rows``/``results`` are read: the top-level ``meta`` provenance
    block (git sha, timestamp, device) is deliberately never diffed —
    it changes every run by design."""
    out: Dict[str, Tuple[float, str]] = {}
    section = doc.get("section", "?")
    res = doc.get("results") or {}
    if section == "serve":
        base = res.get("baseline_sequential") or {}
        keys = _LAT_KEYS + _THROUGHPUT_KEYS + (
            ("service_p95_us", LOWER), ("service_mean_us", LOWER))
        for key, direction in keys:
            if key in base:
                out[f"serve/sequential/{key}"] = (float(base[key]), direction)
        # tracer overhead: the honest cost of observability, measured by
        # loadgen running the same closed-loop section with a live
        # SpanTracer vs NULL_TRACER. Lower is better; the throughputs
        # themselves are machine-relative and excluded. The gate tracks
        # the min-of-pairs lower bound, not the median — the median
        # swings with one-sided scheduler jitter (0-15% on a loaded
        # box) while the lower bound isolates the systematic cost.
        to = res.get("tracer_overhead") or {}
        if "overhead_pct_lb" in to:
            out["serve/tracer/overhead_pct_lb"] = (
                float(to["overhead_pct_lb"]), LOWER)
        elif "overhead_pct" in to:
            out["serve/tracer/overhead_pct"] = (
                float(to["overhead_pct"]), LOWER)
        for b, rec in (res.get("backends") or {}).items():
            for mode, r in rec.items():
                if not isinstance(r, dict):
                    continue
                # open-loop latencies (incl. the slo_lanes open loop)
                # are queueing at a machine-relative offered rate —
                # load-amplified, not comparable across machines (see
                # module docstring)
                keys = (_SLO_KEYS + _THROUGHPUT_KEYS
                        if mode in ("open_loop", "slo_lanes")
                        else _LAT_KEYS + _THROUGHPUT_KEYS + _SLO_KEYS)
                for key, direction in keys:
                    if key in r:
                        out[f"serve/{b}/{mode}/{key}"] = (
                            float(r[key]), direction)
                for lane, lrec in (r.get("lanes") or {}).items():
                    if not isinstance(lrec, dict):
                        continue
                    for key, direction in _SLO_KEYS:
                        if key in lrec:
                            out[f"serve/{b}/{mode}/lane{lane}/{key}"] = (
                                float(lrec[key]), direction)
    elif isinstance(res, dict) and res:
        for k, v in res.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[f"{section}/{k}"] = (float(v), LOWER)
    else:                                   # generic fallback: CSV rows
        for row in doc.get("rows") or []:
            out[row["name"]] = (float(row["us_per_call"]), LOWER)
    return out


_RATE_SUFFIXES = ("deadline_miss_rate", "slo_attainment")
# percent-scale metrics ([0, 100]): same floor logic as rates but in
# percentage points (floor = 100 * min_rate), so a 0.3% -> 1.2%
# tracer-overhead wobble is noise while 0.3% -> 40% still fails
_PCT_SUFFIXES = ("overhead_pct", "overhead_pct_lb")
# dimensionless cross-kernel ratios (``<kernel>_vs_<other>_x``): already
# machine-normalized by construction, so they bypass both the µs noise
# floor and the drift correction — these are the rows that keep a
# kernel from silently regressing relative to its own oracle (the old
# gate let aig_sim sit 210x over its jnp ref because both sides of the
# diff carried the same slow number). Floored at ``min_ratio`` so
# "fast, got slightly less fast" (0.04x -> 0.1x) is noise while
# "comparable, got 10x slower" still fails.
_RATIO_SUFFIX = "_x"


def _is_rate(name: str) -> bool:
    return name.endswith(_RATE_SUFFIXES)


def _is_pct(name: str) -> bool:
    return name.endswith(_PCT_SUFFIXES)


def _is_ratio(name: str) -> bool:
    return name.endswith(_RATIO_SUFFIX)


def compare(base: Dict[str, Tuple[float, str]],
            fresh: Dict[str, Tuple[float, str]],
            tolerance: float, min_us: float,
            normalize: bool = True, max_drift: float = 3.0,
            min_rate: float = 0.05, min_ratio: float = 0.5):
    """Returns (regressions, checked, only_one_side, drift).

    ``checked`` rows are (name, base, fresh, raw_ratio, residual,
    direction); a row regresses when its drift-normalized residual
    exceeds 1 + tolerance. ``residual`` is oriented so that > 1 always
    means "worse", whichever direction the metric prefers.

    Rate metrics ([0, 1] fractions: deadline-miss rate, SLO attainment)
    are floored at ``min_rate`` on both sides instead of being skipped
    at zero — a miss rate's *healthy* value is exactly 0.0, and the
    generic zero-skip would make a regression from a clean baseline
    (0.0 -> 0.4) invisible. The floor doubles as the noise tolerance:
    0.0 -> 0.03 compares as 1x, 0.0 -> 0.4 as 8x.

    Dimensionless ``*_x`` ratios (kernel-vs-oracle) get the same
    treatment with ``min_ratio``: floored, ungated by ``min_us``, and
    never drift-corrected — both sides of a ratio ran on the same
    machine, so any movement is the kernel's own."""
    effective: Dict[str, float] = {}
    rows = []
    for name in sorted(set(base) | set(fresh)):
        if name not in base or name not in fresh:
            rows.append((name, None))
            continue
        bv, direction = base[name]
        fv = fresh[name][0]
        if _is_rate(name):
            cb, cf = max(bv, min_rate), max(fv, min_rate)
        elif _is_pct(name):
            cb = max(bv, 100.0 * min_rate)
            cf = max(fv, 100.0 * min_rate)
        elif _is_ratio(name):
            cb, cf = max(bv, min_ratio), max(fv, min_ratio)
        else:
            if direction == LOWER and max(bv, fv) < min_us:
                continue                     # sub-floor: timer noise
            if bv <= 0 or fv <= 0:
                continue
            cb, cf = bv, fv
        ratio = cf / cb
        effective[name] = ratio if direction == LOWER else 1.0 / ratio
        rows.append((name, (bv, fv, ratio, direction)))

    drift = 1.0
    # drift estimates the uniform machine-speed factor — from timing
    # metrics only; rates are fractions of offered load and neither
    # inform nor receive the correction
    timing = [v for n, v in effective.items()
              if not _is_rate(n) and not _is_pct(n) and not _is_ratio(n)]
    if normalize and len(timing) >= 3:       # too few metrics to estimate
        drift = median(timing)
        drift = min(max(drift, 1.0 / max_drift), max_drift)

    regressions, checked, only_one = [], [], []
    for name, payload in rows:
        if payload is None:
            only_one.append(name)
            continue
        bv, fv, ratio, direction = payload
        residual = effective[name] / (
            1.0 if _is_rate(name) or _is_pct(name) or _is_ratio(name)
            else drift)
        row = (name, bv, fv, ratio, residual, direction)
        checked.append(row)
        if residual > 1.0 + tolerance:
            regressions.append(row)
    return regressions, checked, only_one, drift


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fail CI when fresh benchmark JSONs regress past "
                    "tolerance vs committed baselines")
    ap.add_argument("--tolerance", type=float, default=0.25,
                    help="allowed relative slowdown after drift "
                         "normalization (0.25 = 25%%)")
    ap.add_argument("--min-us", type=float, default=50.0,
                    help="skip latency metrics where both sides are "
                         "below this (timer noise)")
    ap.add_argument("--min-rate", type=float, default=0.05,
                    help="floor for rate metrics (miss rate / "
                         "attainment): values below it compare as "
                         "equal, so a clean 0.0 baseline still catches "
                         "a real regression without noise-failing")
    ap.add_argument("--min-ratio", type=float, default=0.5,
                    help="floor for dimensionless *_x cross-kernel "
                         "ratios: both sides below it compare as equal "
                         "(already fast), above it the ratio is gated "
                         "raw with no drift correction")
    ap.add_argument("--no-normalize", action="store_true",
                    help="compare raw ratios (no median machine-speed "
                         "drift correction)")
    ap.add_argument("--max-drift", type=float, default=3.0,
                    help="clamp for the drift estimate: an "
                         "across-the-board slowdown beyond this still "
                         "fails")
    ap.add_argument("--files", default=",".join(DEFAULT_FILES),
                    help="comma list of BENCH json names")
    ap.add_argument("--fresh-dir", default=REPO_ROOT,
                    help="directory holding the freshly written JSONs")
    ap.add_argument("--baseline-dir", default=None,
                    help="baseline directory (default: git show HEAD:)")
    args = ap.parse_args(argv)

    any_regression = False
    any_checked = False
    for name in args.files.split(","):
        name = name.strip()
        fresh_path = os.path.join(args.fresh_dir, name)
        if not os.path.exists(fresh_path):
            print(f"[regress] {name}: no fresh file — skipped")
            continue
        try:
            with open(fresh_path) as f:
                fresh_doc = json.load(f)
        except json.JSONDecodeError as e:
            print(f"[regress] ERROR: fresh file {fresh_path} is not "
                  f"valid JSON ({e}). The benchmark step that writes it "
                  f"likely crashed mid-write — re-run it before the "
                  f"regression gate.")
            return 2
        try:
            base_doc = load_baseline(name, args.baseline_dir)
        except BaselineError as e:
            print(f"[regress] ERROR: {e}")
            return 2
        if base_doc is None:
            print(f"[regress] {name}: no baseline at "
                  f"{'HEAD' if not args.baseline_dir else args.baseline_dir}"
                  f" — skipped (new benchmark file?)")
            continue
        regs, checked, only_one, drift = compare(
            extract_metrics(base_doc), extract_metrics(fresh_doc),
            args.tolerance, args.min_us,
            normalize=not args.no_normalize, max_drift=args.max_drift,
            min_rate=args.min_rate, min_ratio=args.min_ratio)
        any_checked = any_checked or bool(checked)
        print(f"[regress] {name}: {len(checked)} metrics checked "
              f"(drift x{drift:.2f}), {len(only_one)} one-sided "
              f"(ignored), {len(regs)} regression(s) at tolerance "
              f"{args.tolerance:.0%}")
        for row in checked:
            mname, bv, fv, ratio, residual, direction = row
            flag = "  REGRESSION" if row in regs else ""
            print(f"  {mname}: {bv:.1f} -> {fv:.1f} (x{ratio:.2f} raw, "
                  f"x{residual:.2f} vs drift, {direction} better){flag}")
        if regs:
            any_regression = True
    if not any_checked:
        print("[regress] WARNING: no overlapping metrics found anywhere")
    if any_regression:
        print("[regress] FAIL: benchmark regression(s) past tolerance")
        return 1
    print("[regress] OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
