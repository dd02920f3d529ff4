"""Smoke-sized cells for the CPU tests: the port's glm4-smoke and
nemotron-smoke widths under the cells' mixes cut to a few requests."""
from __future__ import annotations

import copy
import time

import torch

from perfbench import harness

GLM4_SMOKE = {"name": "glm4-smoke", "family": "dense", "n_layers": 2,
              "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 160,
              "vocab_size": 512, "act": "swiglu", "rope_theta": 10000.0,
              "rotary_pct": 0.5, "norm_eps": 1e-05, "param_dtype": "float32",
              "compute_dtype": "bfloat16"}
NEMOTRON_SMOKE = {**GLM4_SMOKE, "name": "nemotron-smoke", "d_ff": 256,
                  "act": "relu2"}
# The cells' limits hold at the cells' widths. At width 64 bf16 rounds
# each loss and norm more coarsely: on the CPU, glm4-smoke's port reads
# loss / grad / change gaps of 2.2e-4 / 1.5e-3 / 1.7e-3, its e4m3 control
# 3.0e-3 / 4.4e-2 / 9.3e-3 and half of the batch 2.0e-2 / 0.18 / 0.24.
SMOKE_TRAIN_LIMITS = {"train_loss_gap": 1e-3, "train_grad_gap": 1e-2,
                      "train_change_gap": 5e-3}


def train_mix():
    mix = copy.deepcopy(harness.load_traffic("train_b2_s4096"))
    mix.update(batch=2, seq=64, trace_steps=2)
    return mix


def serve_mix(name: str = "closed_azure_conv"):
    mix = copy.deepcopy(harness.load_traffic(name))
    mix.update(clients=3, slots=3, max_seq=48, pool=64, prewarm_s=0.2,
               trace_ticks=5, check_served_tokens=12,
               prompt_tokens={"dist": "loguniform", "min": 4, "max": 16},
               output_tokens={"dist": "uniform", "min": 2, "max": 8})
    return mix


def make_run(cell: str, arch: dict, mix: dict, seed: int = 7,
             seconds: float = 1.0, trace: bool = False, limits=None):
    if limits is None:
        limits = (SMOKE_TRAIN_LIMITS if mix["kind"] == "train"
                  else harness.load_limits(cell))
    return harness.Run(cell=cell, config={"arch": arch}, traffic=mix,
                       limits=limits, seed=seed,
                       seconds=seconds, trace=trace,
                       device=torch.device("cpu"), t0=time.perf_counter())
