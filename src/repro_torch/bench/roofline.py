"""Roofline of the port's dry-run records (``repro_torch.launch.dryrun``),
the twin of the reference's ``benchmarks/roofline.py``, at an H100
SXM's rates.

Per (arch x shape x mesh) cell:
    compute term    = FLOPs per device / PEAK_FLOPS
    memory term     = bytes per device / HBM_BW   [raw + analytic]
    collective term = wire bytes per device / NET_BW

The FLOPs, bytes and collective bytes are the record's ``extrapolated``
block (the port's records count their unrolled layers directly, so it
equals the direct count). Wire bytes apply ring-algorithm factors per
collective kind. The dry run's bytes are unfused (every op's inputs and
outputs), so the memory term is reported both raw and by the analytic
model (parameters, moments and activation residency); dominance uses
compute, collective and the analytic memory term.

The rates (each per GPU):
  * PEAK_FLOPS, 989 TFLOP/s: dense bf16 tensor-core rate of the H100
    SXM5 (NVIDIA H100 Tensor Core GPU datasheet; 1,979 with sparsity);
  * HBM_BW, 3.35 TB/s: its HBM3 bandwidth (same datasheet). These two
    are the rates ``chip_smoke.py``'s bounds and PERF.md use;
  * NET_BW, 50 GB/s: one 400 Gb/s NDR InfiniBand ConnectX-7 port per
    GPU, as a DGX H100 has (DGX H100 user guide). The production mesh's
    model axis of 16 spans two 8-GPU nodes, so its collectives cross
    that link. The single collective term leaves out the faster link
    inside a node, NVLink 4 at 900 GB/s per GPU (datasheet).

MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for train; 2*N*D for
inference steps.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.launch.dryrun import DEFAULT_OUT as DRYRUN_DIR

PEAK_FLOPS = 989e12        # bf16 FLOP/s a GPU, H100 SXM5 (datasheet)
HBM_BW = 3.35e12           # B/s a GPU, HBM3 (datasheet)
NET_BW = 50e9              # B/s a GPU, 400 Gb/s NDR (DGX H100)

# ring-algorithm wire factors (n = ring size; use n=16 nominal)
_ALGO_FACTOR = {
    "all-reduce": 2.0 * 15 / 16,
    "all-gather": 15 / 16,
    "reduce-scatter": 15 / 16,
    "all-to-all": 15 / 16,
    "collective-permute": 1.0,
}


def model_flops(rec: Dict) -> float:
    """6*N_active*tokens for train; 2*N_active*tokens for inference."""
    from repro_torch.configs import ARCHS, SHAPES
    cfg = ARCHS[rec["arch"]]
    shape = SHAPES[rec["shape"]]
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per row


def analytic_memory_bytes(rec: Dict) -> float:
    """Per-device HBM traffic model for one step."""
    from repro_torch.configs import ARCHS, SHAPES
    cfg = ARCHS[rec["arch"]]
    shape = SHAPES[rec["shape"]]
    n_dev = rec["n_devices"]
    n = cfg.param_count()
    d = cfg.d_model
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        # params: bf16 read fwd + bwd(x2: wgrad+igrad passes) + remat fwd
        w = 2.0 * n * 4
        # optimizer: read p,m,v f32 + grads f32; write p,m,v
        opt = n * 4 * 7
        # activations: ~14 tensor-residencies/layer (stored + re-read in
        # bwd), bf16
        act = cfg.n_layers * tokens * d * 14 * 2
        return (w + opt + act) / n_dev
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        w = n * 2
        act = cfg.n_layers * tokens * d * 6 * 2
        cache = kv_cache_bytes(cfg, shape)
        return (w + act + cache) / n_dev
    # decode: weights once + full KV/SSM cache read + write of one slot
    w = 2.0 * cfg.active_param_count()
    cache = kv_cache_bytes(cfg, shape)
    return (w + cache) / n_dev


def kv_cache_bytes(cfg, shape) -> float:
    from repro_torch.models.lm import cache_len
    b = shape.global_batch
    total = 0.0
    if cfg.family != "ssm" and cfg.n_kv_heads:
        w = cache_len(cfg, shape.seq_len)
        total += (2 * cfg.n_layers * b * w * cfg.n_kv_heads
                  * cfg.head_dim * 2)
    if cfg.family in ("ssm", "hybrid"):
        total += cfg.n_layers * b * cfg.d_inner * cfg.ssm_state * 4
    return total


def roofline_row(rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "ok":
        return None
    ex = rec["extrapolated"]
    n_dev = rec["n_devices"]
    flops = ex["flops_per_device"]
    raw_bytes = ex["bytes_accessed_per_device"]
    wire = sum(v * _ALGO_FACTOR[k] for k, v in ex["collective_bytes"].items())

    t_compute = flops / PEAK_FLOPS
    t_mem_raw = raw_bytes / HBM_BW
    t_mem = analytic_memory_bytes(rec) / HBM_BW
    t_coll = wire / NET_BW
    terms = {"compute": t_compute, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec)
    step = max(terms.values())
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "t_compute_s": t_compute, "t_memory_s": t_mem,
        "t_memory_raw_s": t_mem_raw, "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_total": mf,
        "hlo_flops_total": flops * n_dev,
        "useful_flops_ratio": mf / max(flops * n_dev, 1.0),
        "roofline_fraction": (mf / n_dev / PEAK_FLOPS) / max(step, 1e-12),
        "collective_bytes_per_dev": wire,
    }


def load_rows(dryrun_dir: Optional[str] = None) -> List[Dict]:
    """The roofline rows of every ``ok`` record in ``dryrun_dir``
    (default ``DRYRUN_DIR``, read at call time)."""
    rows = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir or DRYRUN_DIR,
                                              "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        row = roofline_row(rec)
        if row:
            rows.append(row)
    return rows


def format_table(rows: List[Dict], mesh: str = "single") -> str:
    hdr = (f"{'arch':24} {'shape':12} {'comp(s)':>9} {'mem(s)':>9} "
           f"{'coll(s)':>9} {'dominant':>10} {'useful':>7} {'roofl%':>7}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        lines.append(
            f"{r['arch']:24} {r['shape']:12} {r['t_compute_s']:9.4f} "
            f"{r['t_memory_s']:9.4f} {r['t_collective_s']:9.4f} "
            f"{r['dominant']:>10} {r['useful_flops_ratio']:7.2f} "
            f"{100*r['roofline_fraction']:6.1f}%")
    return "\n".join(lines)


def run(dryrun_dir: Optional[str] = None) -> List[Dict]:
    rows = load_rows(dryrun_dir)
    if not rows:
        print("[roofline] no dry-run results found — run "
              "`python -m repro_torch.launch.dryrun` first")
        return rows
    print(format_table(rows, "single"))
    n_multi = sum(r["mesh"] == "multi" for r in rows)
    print(f"\n[roofline] {len(rows) - n_multi} single-pod rows above; "
          f"{n_multi} multi-pod cells counted OK (H100 SXM rates: "
          f"{PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, {HBM_BW / 1e12:.2f} TB/s "
          f"HBM3, {NET_BW / 1e9:.0f} GB/s a GPU between nodes)")
    return rows


if __name__ == "__main__":
    run()
