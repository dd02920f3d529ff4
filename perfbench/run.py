"""Run one cell of BENCHMARK.json and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the card(s) the cell
asks for. The last line of standard output is one JSON object (correct,
attempted, failed, metrics, device, with --trace 1 also breakdown, and
last the numbers compared beside their limits); the same numbers go to
standard error as its last lines. With --trace 0 the metrics are the
cell's end-to-end ones, with --trace 1 its per-layer ones. Without the
card(s), or with JAX or the JAX package loaded once the window has
closed, it exits non-zero and prints no result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

EXIT_NO_DEVICE = 2
EXIT_FORBIDDEN_IMPORT = 3


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def caches_in_checkout() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own library cache is ``build/repro_torch_kernels``)."""
    base = ROOT / "build" / "perfbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))


def finite(x):
    """A number as JSON takes it: None where it is not finite."""
    return x if x is None or math.isfinite(x) else None


def result_line(cell: str, spec: dict, out, r, trace: bool) -> dict:
    from perfbench import harness
    metrics = {}
    if trace:
        sl = out.slice
        for m in harness.cell_metrics(spec, cell, "per_layer"):
            value = None if sl is None else harness.metric_reader(m["name"])(sl)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in harness.cell_metrics(spec, cell, "end_to_end"):
            value = out.values[harness.base_name(m["name"])]
            metrics[m["name"]] = {"value": finite(value), "unit": m["unit"]}
    device = harness.device_description(r.device)
    device["memory_peak_bytes"] = int(out.memory_peak_bytes)
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if trace and out.slice is not None:
        device["busy_s"] = out.slice.busy_s
        device["window_s"] = out.slice.window_s
        line["breakdown"] = {
            "device_ops": harness.top_device_ops(out.slice.ops),
            "idle_gaps": out.slice.gaps}
    line["checks"] = {c.name: {"value": finite(c.value), "limit": c.limit}
                      for c in out.checks}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    caches_in_checkout()
    from perfbench import harness
    spec = harness.benchmark_spec()
    cell = harness.find_cell(spec, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return EXIT_NO_DEVICE
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    config = harness.load_config(spec, cell["config"])
    traffic = harness.load_traffic(cell["traffic"])
    r = harness.Run(cell=args.workload, config=config, traffic=traffic,
                    limits=harness.load_limits(args.workload),
                    seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), device=device, t0=T0)
    r.device_kind = torch.cuda.get_device_name(device)
    r.log(f"card {harness.power_limit()}; seed {args.seed}")
    out = harness.kind_module(traffic["kind"]).run(r)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return EXIT_FORBIDDEN_IMPORT
    line = result_line(args.workload, spec, out, r, bool(args.trace))
    print(json.dumps(line), flush=True)
    for c in out.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print("checks " + json.dumps(line["checks"]), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
