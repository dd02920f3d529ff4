"""Benchmark runner of the port, the twin of the reference's
``benchmarks/run.py``: one section per paper table/figure + repo extras,
each through the port's twin of the reference's module, on the card
unless ``--device cpu``.

Prints ``name,us_per_call,derived`` CSV rows (us_per_call = host wall
time where measured, the kernel rows' times from CUDA events on the
card; hardware-model metrics land in the derived column) and, per
section, writes ``BENCH_<section>_torch.json`` (``{section, meta, rows,
results}``, ``meta`` from ``bench_meta``) into ``--out-dir`` (the repo
root by default):

  table1   — paper Table I (``table1_jsc``): JSC-S/M/L accuracy +
             measured and modeled LUT/FF/fmax vs the LogicNets baseline
  latency  — logic path vs dense float vs XNOR, plus the served
             bitplane walk, µs/call (``latency``)
  ablation — activation-selection + FCP-schedule ablations
  kernels  — kernel microbenchmarks beside their plain versions
  serve    — the scheduler loadgen vs sequential serving (``loadgen``)

The reference's ``roofline`` section needs the LM stack's dry runs,
which the port does not have yet.

    python -m repro_torch.bench.run [--only latency,kernels] [--fast]
        [--history [LEDGER]] [--device cpu] [--out-dir DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

from repro_torch.bench.meta import REPO_ROOT

SECTIONS = ("table1", "latency", "ablation", "kernels", "serve")


def bench_path(out_dir: str, section: str) -> str:
    return os.path.join(out_dir, f"BENCH_{section}_torch.json")


def main(argv=None) -> Dict:
    from repro_torch.bench import history
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.run")
    ap.add_argument("--only", default=None,
                    help="comma list: " + ",".join(SECTIONS))
    ap.add_argument("--fast", action="store_true",
                    help="fewer training steps (CI mode)")
    ap.add_argument("--history", nargs="?", const=history.DEFAULT_LEDGER,
                    default=None, metavar="LEDGER",
                    help="append this run's BENCH_*_torch.json metrics to "
                         "the trajectory ledger (default build/bench/"
                         "history_torch.jsonl; idempotent per git sha + "
                         "timestamp)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--out-dir", default=REPO_ROOT,
                    help="where the BENCH_<section>_torch.json files go")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    unknown = (only or set()) - set(SECTIONS)
    if unknown:
        ap.error(f"unknown section(s) {sorted(unknown)}; the port has "
                 f"{', '.join(SECTIONS)}")
    dev = resolve_device(args.device)
    rows: Dict[str, List[Dict]] = {}
    all_results: Dict = {}

    def want(x):
        return only is None or x in only

    def emit(name: str, us: float, derived: str):
        print(f"{name},{us:.1f},{derived}")
        rows.setdefault(name.split("/", 1)[0], []).append(
            {"name": name, "us_per_call": round(us, 1), "derived": derived})

    print("name,us_per_call,derived")

    if want("table1"):
        from repro_torch.bench import table1_jsc
        t0 = time.time()
        res = table1_jsc.run(steps=300 if args.fast else 1200, device=dev)
        all_results["table1"] = res
        for k, r in res.items():
            emit(f"table1/{k}", (time.time() - t0) * 1e6 / 3,
                 f"acc={r['accuracy']:.4f};luts={r['nullanet']['luts']};"
                 f"luts_backend={r['nullanet']['backend']};"
                 f"luts_model={r['nullanet_model']['luts']};"
                 f"depth={r['nullanet']['depth']};"
                 f"synth_equiv={r['synth']['equivalent']};"
                 f"lut_red={r['lut_reduction_x']}x;"
                 f"fmax={r['nullanet']['fmax_mhz']}MHz;"
                 f"lat_red={r['latency_reduction_x']}x")

    if want("latency"):
        from repro_torch.bench import latency
        res = latency.run(steps=200 if args.fast else 600, device=dev)
        all_results["latency"] = res
        emit("latency/logic", res["logic_us"],
             f"dense={res['dense_float_us']:.0f}us;"
             f"speedup={res['logic_vs_dense_x']}x")

    if want("ablation"):
        from repro_torch.bench import ablations
        res = ablations.run(device=dev)
        all_results["ablation"] = res
        emit("ablation/act", 0.0, json.dumps(res["activation_selection"]))
        emit("ablation/fcp", 0.0, json.dumps(res["fcp_schedule"]))

    if want("kernels"):
        from repro_torch.bench import kernels_bench
        res = kernels_bench.run(device=dev)
        all_results["kernels"] = res
        where = "device" if dev.type == "cuda" else "cpu"
        for k, v in res.items():
            emit(f"kernels/{k}", v, where)

    if want("serve"):
        from repro_torch.bench import loadgen
        res = loadgen.run(fast=args.fast, write_json=False, device=dev)
        all_results["serve"] = res
        base = res["baseline_sequential"]
        emit("serve/sequential", base["p95_us"],
             f"qps={base['qps']:.0f};p50={base['p50_us']:.0f}us;"
             f"service_p95={base['service_p95_us']:.0f}us")
        for b, rec in res["backends"].items():
            for mode, r in rec.items():
                if not isinstance(r, dict):  # per-backend metadata (engine)
                    continue
                emit(f"serve/{b}/{mode}", r["p95_us"],
                     f"qps={r['qps']:.0f};p50={r['p50_us']:.0f}us;"
                     f"p99={r['p99_us']:.0f}us;"
                     f"occ={r['mean_batch_occupancy']:.2f};"
                     f"identical={r['identical_to_classify']}"
                     + (f";speedup={r['throughput_x_sequential']}x"
                        if "throughput_x_sequential" in r else ""))

    from repro_torch.bench.meta import bench_meta
    meta = bench_meta(device=dev)
    os.makedirs(args.out_dir, exist_ok=True)
    for section, section_rows in rows.items():
        with open(bench_path(args.out_dir, section), "w") as f:
            json.dump({"section": section, "meta": meta,
                       "rows": section_rows,
                       "results": all_results.get(section)},
                      f, indent=1, default=str)
    if args.history:
        for section in rows:
            entry = history.append_file(bench_path(args.out_dir, section),
                                        path=args.history)
            if entry is not None:
                print(f"[bench] history: {section} -> "
                      f"{len(entry['metrics'])} metric(s) appended")
    return all_results


if __name__ == "__main__":
    main()
