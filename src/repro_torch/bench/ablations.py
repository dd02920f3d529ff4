"""Ablations over the paper's two training-side contributions, a twin
of the reference's ``benchmarks/ablations.py`` (the same
configurations, steps, data and JSON keys), trained by the port on the
card by default.

  1. Activation selection (paper §QAT): the per-layer rule vs forcing a
     mismatched quantizer family everywhere.
  2. FCP schedule (paper §FCP): gradual (Zhu–Gupta) vs ADMM vs one-shot
     post-training projection.

    PYTHONPATH=src python -m repro_torch.bench.ablations [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
from typing import Dict

from repro_torch.configs.jsc import JSC_DEMO
from repro_torch.data.jsc import train_test
from repro_torch.train.jsc_trainer import train_jsc

CFG = dataclasses.replace(JSC_DEMO, features=(32, 16, 5),
                          fanins=(4, 4, 4), act_bits=(2, 2, 3))
STEPS = 700


@functools.lru_cache(maxsize=1)
def data():
    return train_test(12000, 4000, seed=0)


def act_selection(device=None) -> Dict:
    """Correct rule (signed — JSC features take both signs) vs
    binary-everywhere vs 1-bit sign (capacity ablation)."""
    out = {}
    for tag, in_bits, bits in [("rule_signed2", 2, (2, 2, 3)),
                               ("sign_1bit", 1, (1, 1, 3)),
                               ("signed_3bit", 3, (3, 3, 3))]:
        cfg = dataclasses.replace(CFG, in_bits=in_bits, act_bits=bits)
        res = train_jsc(cfg, steps=STEPS, data=data(), device=device)
        out[tag] = round(res.test_acc, 4)
        print(f"[ablation/act] {tag}: acc={res.test_acc:.4f}", flush=True)
    return out


def fcp_schedules(device=None) -> Dict:
    out = {}
    for tag, kwargs in [("gradual", {"fcp": "gradual"}),
                        ("admm", {"fcp": "admm"}),
                        ("oneshot", {"fcp": "gradual",
                                     "fcp_begin_frac": 0.95,
                                     "fcp_end_frac": 0.96})]:
        res = train_jsc(CFG, steps=STEPS, data=data(), device=device,
                        **kwargs)
        out[tag] = round(res.test_acc, 4)
        print(f"[ablation/fcp] {tag}: acc={res.test_acc:.4f}", flush=True)
    return out


def run(device=None) -> Dict:
    return {"activation_selection": act_selection(device),
            "fcp_schedule": fcp_schedules(device)}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.ablations")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    out = run(ap.parse_args(argv).device)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
