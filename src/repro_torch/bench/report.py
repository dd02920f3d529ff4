"""Markdown tables of the port's dry runs and rooflines, the twin of
the reference's ``benchmarks/report.py``: the roofline of each
single-pod cell, and a summary of every record.

  PYTHONPATH=src python -m repro_torch.bench.report

Both read ``build/dryrun_torch`` by default (``launch.dryrun``'s
``--out``). The reference also compares a second directory of
records made under other sharding strategies; nothing in the port makes
one, so that comparison is left out. The port's records count one device
each, so the summary's argument and temporary GiB are per device as
they stand; its seconds are the record's build plus step.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Optional

from repro_torch.bench import roofline


def _key(r):
    return (r["arch"], r["shape"], r["mesh"])


def markdown_tables(base_dir: Optional[str] = None) -> str:
    """The roofline of each single-pod cell, and the count of multi-pod
    cells."""
    rows = roofline.load_rows(base_dir or roofline.DRYRUN_DIR)
    lines = ["| arch | shape | comp(s) | mem(s) | coll(s) | dominant |"
             " useful | roofline |",
             "|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=_key):
        if r["mesh"] != "single":
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3f} | "
            f"{r['t_memory_s']:.3f} | {r['t_collective_s']:.3f} | "
            f"{r['dominant']} | {r['useful_flops_ratio']:.2f} | "
            f"{100*r['roofline_fraction']:.1f}% |")
    n_multi = sum(1 for r in rows if r["mesh"] == "multi")
    lines.append("")
    lines.append(f"Multi-pod (2x16x16 = 512 devices): {n_multi} cells "
                 "counted OK.")
    return "\n".join(lines)


def dryrun_summary(base_dir: Optional[str] = None) -> str:
    rows = []
    for path in sorted(glob.glob(os.path.join(
            base_dir or roofline.DRYRUN_DIR, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    ok = [r for r in rows if r.get("status") == "ok"]
    skipped = [r for r in rows if r.get("status") == "skipped"]
    lines = ["| arch | shape | mesh | seconds | flops/dev | coll bytes/dev"
             " | args(GiB/dev) | temps(GiB/dev) |",
             "|---|---|---|---|---|---|---|---|"]
    for r in ok:
        e = r.get("extrapolated", {})
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} |"
            f" {r['build_s'] + r['step_s']:.2f} |"
            f" {e.get('flops_per_device', 0):.2e} |"
            f" {e.get('collective_total_bytes', 0):.2e} |"
            f" {r.get('argument_size_in_bytes', 0)/2**30:.2f} |"
            f" {r.get('temp_size_in_bytes', 0)/2**30:.1f} |")
    lines.append("")
    lines.append(f"{len(ok)} cells counted OK; {len(skipped)} skipped "
                 "(full-attention archs at 500k context).")
    return "\n".join(lines)


if __name__ == "__main__":
    print("## Dry-run summary\n")
    print(dryrun_summary())
    print("\n## Roofline\n")
    print(markdown_tables())
