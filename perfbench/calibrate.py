"""Readings that the limits of ``correct`` are set from, at a cell's own
size, many seeds in one process (run on the card; the benchmark's own
runs never run this):

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,... [--seconds S]

For each seed one JSON line: the port's numbers against the reference
(``program``), the control's (the reference in e4m3 put in the port's
place: ``control``) and, for a training cell, each fault's (half of the
batch left out: ``half_batch``; a state left unchanged reads 1 by the
measure and is run by the tests). A served cell runs its loop for
``--seconds`` (long enough to finish the mix's longest requests).
Each reading is also judged by the harness's own checks at the cell's
committed limits (``correct``): the command exits 1 where the port comes
out not correct, or the control or a fault comes out correct.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def train_readings(r) -> dict:
    from perfbench import checks, faults
    from perfbench.kinds import train
    trainer, feed = train.build(r)
    prog = train.first_steps(r, trainer, feed)
    del trainer, feed
    free(r.device)
    with faults.half_batch():
        trainer, feed = train.build(r)
        half = train.first_steps(r, trainer, feed)
    del trainer, feed
    free(r.device)
    ref = train.reference(r, prog["names"])
    free(r.device)
    ctl = train.reference(r, prog["names"], "e4m3")
    free(r.device)
    worst = {}
    for key in ("grad", "change"):
        gaps = checks.leaf_gaps(prog[key], ref[key], checks.moved_leaves(ref)
                                if key == "change" else ref[key])
        worst[key] = sorted(gaps.items(), key=lambda kv: -kv[1])[:4]
    return {"program": checks.train_named(checks.train_readings(prog, ref)),
            "control": checks.train_named(checks.train_readings(ctl, ref)),
            "half_batch": checks.train_named(checks.train_readings(half,
                                                                   ref)),
            "worst": worst,
            "losses": {"program": prog["losses"], "reference": ref["losses"],
                       "control": ctl["losses"]}}


def serve_readings(r) -> dict:
    from perfbench import checks
    from perfbench.kinds import closed_serve as serve
    out = serve.measure(r)
    prog = serve.reference_gaps(r, out.picked)
    free(r.device)
    ctl = serve.reference_gaps(r, out.picked, "e4m3", against="float32")
    free(r.device)
    return {"program": checks.serve_readings(prog),
            "control": checks.serve_readings(ctl),
            "served_tokens": int(len(prog)), "requests": len(out.picked),
            "slots": len({d["slot"] for d in out.picked}),
            "output_tokens_per_s": out.values["output_tokens_per_s"]}


ROLES = ("program", "control", "half_batch")


def verdicts(rd: dict, limits: dict) -> dict:
    """``correct`` of each role's readings by the harness's checks at
    ``limits``."""
    from perfbench import checks
    return {role: checks.correct(checks.judge(rd[role], limits))
            for role in ROLES if role in rd}


def sound(verdict: dict) -> bool:
    """The port correct, the control and every fault not."""
    return all(v == (role == "program") for role, v in verdict.items())


def free(device) -> None:
    import gc
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args()
    import torch
    from perfbench import harness
    spec = harness.benchmark_spec()
    cell = harness.find_cell(spec, args.workload)
    mix = harness.load_traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    failed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = harness.Run(cell=args.workload,
                        config=harness.load_config(spec, cell["config"]),
                        traffic=mix, limits=harness.load_limits(args.workload),
                        seed=seed, seconds=args.seconds, trace=False,
                        device=device, t0=time.perf_counter())
        rd = (train_readings(r) if mix["kind"] == "train"
              else serve_readings(r))
        rd["correct"] = verdicts(rd, r.limits)
        rd.update(workload=args.workload, seed=seed,
                  seconds=time.perf_counter() - t)
        print(json.dumps(rd), flush=True)
        if not sound(rd["correct"]):
            failed.append(seed)
    if failed:
        print(f"calibrate: seeds {failed}: the port not correct, or the "
              "control or a fault correct, at the committed limits",
              file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
