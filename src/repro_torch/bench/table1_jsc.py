"""Table I: NullaNet Tiny vs LogicNets on JSC-S/M/L, a twin of the
reference's ``benchmarks/table1_jsc.py`` (the same flow, steps, data and
record keys), trained on the card by default.

Per architecture:
  * train with the paper's flow (QAT w/ per-layer activation selection +
    gradual FCP), compile to logic, espresso+DC minimize, map to 6-LUTs;
  * report BOTH LUT/depth numbers: the *measured* structural mapping
    from ``repro_torch.synth`` (AIG -> rewrite -> FlowMap-style 6-LUT
    cover) and the analytic cost model it replaces (kept as a
    comparison column), plus a random-simulation equivalence check of
    the mapped whole-network netlist against the truth-table oracle,
    the netlist run through ``compile_logic_network`` on the device
    (the streamed lut_eval walk on the card), and the SAT sweep's
    proven duplicate-LUT outputs;
  * the LogicNets baseline maps the SAME trained truth tables without
    two-level minimization (raw LUT-RAM cascades), matching how LogicNets
    realises neurons;
  * report accuracy, LUTs, FFs, fmax and the NullaNet/LogicNets ratios —
    the paper's claim structure (Dec. x / Inc. x columns).

LUTs, FFs and fmax are the FPGA cost model's (``core.lutmap``), not a
time on any device. Synthetic-data caveat: absolute accuracy differs
from the paper; the reproduced quantities are the ratios and orderings.

    PYTHONPATH=src python -m repro_torch.bench.table1_jsc [--device cpu]
        [--steps N] [--arch jsc-s ...] [--out BENCH_table1_torch.json]

It writes JSON only with ``--out`` (or ``run(..., out=PATH)``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.jsc import JSC
from repro_torch.core.logic_infer import hardware_report
from repro_torch.core.lutmap import structural_report
from repro_torch.data.jsc import train_test
from repro_torch.device import resolve_device
from repro_torch.models.mlp import to_logic
from repro_torch.train.jsc_trainer import train_jsc

ARCHS = ("jsc-s", "jsc-m", "jsc-l")


def _synth_equivalence(net, n_samples: int = 4096, seed: int = 0,
                       device=None) -> Dict:
    """Compile the whole network through repro_torch.synth and check the
    mapped netlist, run on ``device`` by its default engine, against the
    truth-table oracle on random *reachable* inputs (bit-exact decoded
    outputs, packed-bitplane execution)."""
    from repro_torch.check.sat import (find_duplicate_lut_outputs,
                                       merge_duplicate_lut_outputs)
    from repro_torch.synth import compile_logic_network

    dev = resolve_device(device)
    t0 = time.time()
    bit = compile_logic_network(net, effort=1, device=dev)
    t_compile = time.time() - t0
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(0.0, 2.0, (n_samples, net.n_inputs)),
                        dtype=torch.float32)
    ref = net(x).numpy()
    t0 = time.time()
    got = bit(x)
    t_exec = time.time() - t0
    # SAT sweep: measured (proven) duplicate-LUT savings on the mapped net
    t0 = time.time()
    pairs, _ = find_duplicate_lut_outputs(bit.mapped, seed=seed)
    swept = merge_duplicate_lut_outputs(bit.mapped, pairs)
    t_sweep = time.time() - t0
    return {
        "equivalent": bool(np.array_equal(got, ref)),
        "luts": bit.mapped.n_luts,
        "depth": bit.mapped.depth,
        "n_samples": n_samples,
        "compile_seconds": round(t_compile, 1),
        "exec_us_per_call": round(t_exec * 1e6, 1),
        "sat_sweep": {
            "dup_lut_outputs": len(pairs),
            "luts_after_sweep": swept.n_luts,
            "sweep_seconds": round(t_sweep, 1),
        },
    }


def _logicnets_cfg(cfg):
    """LogicNets-style realisation of the same topology: the same
    topology at +1 bit everywhere, each neuron's raw truth table mapped
    without two-level minimization or don't-cares (the reference's
    model of the baseline)."""
    return dataclasses.replace(
        cfg, in_bits=cfg.in_bits + 1,
        act_bits=tuple(b + 1 for b in cfg.act_bits))


def run_one(name: str, steps: int = 1200, seed: int = 0,
            device=None) -> Dict:
    """One row of Table I; prints each stage as it ends (a run cut by a
    time limit shows how far it got)."""
    dev = resolve_device(device)
    cfg = JSC[name]
    t_start = time.time()

    def stage(what: str) -> None:
        print(f"[table1] {name}: {what} ({time.time() - t_start:.1f}s)",
              flush=True)

    data = train_test(20000, 5000, seed)
    res = train_jsc(cfg, steps=steps, seed=seed, data=data, device=dev)
    net = to_logic(cfg, res.model)
    stage(f"trained {steps} steps, compiled to tables")

    t0 = time.time()
    mini, _ = hardware_report(net, minimize_logic=True)
    t_min = time.time() - t0
    stage("minimized and mapped per neuron")

    # measured structural mapping (repro_torch.synth) alongside the model
    t0 = time.time()
    meas, _, meas_backend = structural_report(net)
    t_synth = time.time() - t0
    stage("structural mapping per layer")
    equiv = _synth_equivalence(net, device=dev)
    stage("whole network synthesized, run and swept")

    # LogicNets-style: +1-bit network, raw-table mapping
    ln_cfg = _logicnets_cfg(cfg)
    ln_res = train_jsc(ln_cfg, steps=steps, seed=seed, data=data,
                       device=dev)
    ln_net = to_logic(ln_cfg, ln_res.model)
    base, _ = hardware_report(ln_net, minimize_logic=False)
    stage("LogicNets baseline trained and mapped")

    n_stages = cfg.n_layers + 1  # per-layer pipeline + output reg
    lat_nn = n_stages * 1e3 / meas.fmax_mhz
    lat_ln = n_stages * 1e3 / base.fmax_mhz
    return {
        "arch": name,
        "accuracy": res.test_acc,
        "float_accuracy": res.float_test_acc,
        "logicnets_accuracy": ln_res.test_acc,
        "nullanet": {"luts": meas.luts, "depth": meas.depth,
                     "ffs": meas.ffs,
                     "fmax_mhz": round(meas.fmax_mhz, 1),
                     "latency_ns": round(lat_nn, 2),
                     "backend": meas_backend},
        "nullanet_model": {"luts": mini.luts, "depth": mini.depth,
                           "ffs": mini.ffs,
                           "fmax_mhz": round(mini.fmax_mhz, 1)},
        "synth": equiv,
        "logicnets_baseline": {"luts": base.luts, "ffs": base.ffs,
                               "fmax_mhz": round(base.fmax_mhz, 1),
                               "latency_ns": round(lat_ln, 2)},
        "lut_reduction_x": round(base.luts / max(meas.luts, 1), 2),
        "fmax_increase_x": round(meas.fmax_mhz / base.fmax_mhz, 2),
        "latency_reduction_x": round(lat_ln / max(lat_nn, 1e-9), 2),
        "minimize_seconds": round(t_min, 1),
        "synth_seconds": round(t_synth, 1),
    }


def run(steps: int = 1200, device=None, archs: Sequence[str] = ARCHS,
        out: Optional[str] = None) -> Dict:
    dev = resolve_device(device)
    res = {}
    for name in archs:
        res[name] = run_one(name, steps=steps, device=dev)
        r = res[name]
        print(f"[table1] {name}: acc={r['accuracy']:.4f} "
              f"(LN {r['logicnets_accuracy']:.4f}, "
              f"float {r['float_accuracy']:.4f}) "
              f"LUTs {r['nullanet']['luts']} "
              f"(model {r['nullanet_model']['luts']}) "
              f"vs {r['logicnets_baseline']['luts']} "
              f"({r['lut_reduction_x']}x) "
              f"depth {r['nullanet']['depth']} "
              f"fmax {r['nullanet']['fmax_mhz']}MHz "
              f"({r['fmax_increase_x']}x) "
              f"lat ({r['latency_reduction_x']}x) "
              f"equiv={r['synth']['equivalent']}", flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
    return res


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.table1_jsc")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--steps", type=int, default=1200,
                    help="QAT + FCP steps per network (the reference's)")
    ap.add_argument("--arch", nargs="+", default=list(ARCHS),
                    choices=list(ARCHS))
    ap.add_argument("--out", default=None, metavar="JSON",
                    help="write the records here (nothing is written "
                         "without it)")
    args = ap.parse_args(argv)
    res = run(args.steps, args.device, args.arch, args.out)
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
