"""``python -m repro_torch.check`` — run the static-analysis passes.

By default trains a tiny JSC-S model (on the card; ``--device cpu``
trains on the CPU, and without a card and without ``--device`` it
raises), compiles it to logic, and runs
every pass (netlist lint, stage equivalence, device-plan validation)
over the real pipeline, plus the source-level passes (concurrency
lint, duplicate-definition watchlist) and the trace-schema pass
(``--trace-file`` validates an exported repro_torch.obs trace; without it a
synthetic FakeClock scheduler run is traced and validated). ``--fast`` shrinks the training
run and vector counts so the whole thing fits a CI minute; ``--static``
skips the model entirely.

Exit status: 0 = all passes clean, 1 = errors found.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.device import resolve_device

from .pipeline import check_synth_pipeline
from .plan_check import DEFAULT_SMEM_BUDGET
from .report import CheckReport

PASS_CHOICES = ("lint", "equiv", "plan", "concurrency", "srclint",
                "trace", "formal")


def _build_jsc(fast: bool, seed: int, device=None):
    from repro_torch.configs.jsc import JSC_S
    from repro_torch.data.jsc import train_test
    from repro_torch.models.mlp import to_logic
    from repro_torch.train.jsc_trainer import train_jsc

    n_train, n_test = (2000, 500) if fast else (3000, 800)
    steps = 100 if fast else 200
    data = train_test(n_train, n_test, seed=seed)
    res = train_jsc(JSC_S, steps=steps, batch=128, data=data,
                    device=device)
    return to_logic(JSC_S, res.model)


def _print_formal(rep: CheckReport) -> None:
    """Per-stage UNSAT-proof / conflict statistics + a verdict tally.

    The tally line is machine-greppable — CI gates on ``SAT=0`` (no
    proven inequivalence) and ``UNPROVEN=0`` (every wide cone actually
    proved within the conflict budget).
    """
    tally = {"UNSAT": 0, "SAT": 0, "UNPROVEN": 0}
    for key in sorted(rep.info):
        if not key.startswith("formal["):
            continue
        st = rep.info[key]
        stage = key[len("formal["):-1]
        tally[st["verdict"]] = tally.get(st["verdict"], 0) + 1
        print(f"[check] formal {stage}: {st['verdict']} "
              f"({st.get('outputs', '?')} outputs, "
              f"{st.get('outputs_merged', '?')} merged by sweep, "
              f"{st.get('queries', 0)} SAT queries, "
              f"{st.get('conflicts', 0)} conflicts, "
              f"{st.get('nodes', 0)} miter nodes)")
    sw = rep.info.get("sat_sweep")
    if sw:
        print(f"[check] formal sat-sweep: {sw['dup_lut_outputs']} duplicate "
              f"LUT output(s); {sw['luts']} -> {sw['luts_after_sweep']} "
              f"LUTs after merge ({sw['sat_queries']} queries, "
              f"{sw['conflicts']} conflicts)")
    print(f"[check] formal verdicts: UNSAT={tally['UNSAT']} "
          f"SAT={tally['SAT']} UNPROVEN={tally['UNPROVEN']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="Static netlist verification, device-plan validation "
                    "and concurrency lint for the synth->serve stack.")
    ap.add_argument("--fast", action="store_true",
                    help="small training run + fewer miter vectors "
                    "(CI budget, < ~60 s)")
    ap.add_argument("--static", action="store_true",
                    help="source-level passes only (no model training)")
    ap.add_argument("--passes", default=None,
                    help="comma-separated subset of: "
                    + ",".join(PASS_CHOICES))
    ap.add_argument("--effort", type=int, default=1,
                    help="rewrite/balance rounds before mapping")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smem-budget-kb", type=float, default=None,
                    help="shared memory one block of the lut_eval walks "
                    "may use, in KiB (default "
                    f"{DEFAULT_SMEM_BUDGET / 2**10:.0f})")
    ap.add_argument("--conflict-budget", type=int, default=None,
                    help="SAT conflict budget for the formal pass "
                    "(default: repro_torch.check.sat.DEFAULT_CONFLICT_BUDGET); "
                    "exceeding it yields UNPROVEN warnings, not a pass")
    ap.add_argument("--trace-file", default=None, metavar="PATH",
                    help="exported trace (Chrome JSON or JSONL) for the "
                    "trace pass; without it a synthetic FakeClock "
                    "scheduler run is validated instead")
    ap.add_argument("--device", default=None,
                    help="torch device the JSC-S model trains on (default "
                    "cuda; cpu trains on the CPU)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="show warnings, not just errors")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    wanted = (set(p.strip() for p in args.passes.split(","))
              if args.passes else set(PASS_CHOICES))
    bad = wanted - set(PASS_CHOICES)
    if bad:
        ap.error(f"unknown pass(es): {', '.join(sorted(bad))}")

    budget = (DEFAULT_SMEM_BUDGET if args.smem_budget_kb is None
              else int(args.smem_budget_kb * 2**10))
    t0 = time.time()
    reports = []

    if "trace" in wanted:
        from .tracecheck import (check_phase_reconciliation, check_trace,
                                 check_trace_file,
                                 synthetic_trace_events)
        if args.trace_file:
            reports.append(check_trace_file(args.trace_file))
        else:
            print("[check] no --trace-file: validating a synthetic "
                  "FakeClock scheduler trace ...", flush=True)
            events, n_dropped = synthetic_trace_events()
            rep = check_trace(events, n_dropped=n_dropped)
            reports.append(check_phase_reconciliation(
                events, n_dropped=n_dropped, report=rep))

    if wanted & {"concurrency", "srclint"}:
        static = CheckReport("static")
        if "concurrency" in wanted:
            from .concurrency import check_concurrency
            static.merge(check_concurrency())
        if "srclint" in wanted:
            from .srclint import check_duplicate_definitions
            static.merge(check_duplicate_definitions())
        reports.append(static)

    if not args.static and wanted & {"lint", "equiv", "plan", "formal"}:
        print("[check] building JSC-S artifacts "
              f"({'fast' if args.fast else 'full'}, device {device}) ...",
              flush=True)
        net = _build_jsc(args.fast, args.seed, device)
        rep = check_synth_pipeline(net=net, effort=args.effort,
                                   fast=args.fast,
                                   smem_budget_bytes=budget,
                                   seed=args.seed,
                                   formal="formal" in wanted,
                                   conflict_budget=args.conflict_budget)
        if "formal" in wanted:
            _print_formal(rep)
        if wanted != set(PASS_CHOICES):
            rep.issues = [i for i in rep.issues if i.pass_name in wanted]
        reports.append(rep)

    ok = True
    for rep in reports:
        print(rep.format(verbose=args.verbose))
        ok = ok and rep.ok
    print(f"[check] {'PASS' if ok else 'FAIL'} in {time.time() - t0:.1f} s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
