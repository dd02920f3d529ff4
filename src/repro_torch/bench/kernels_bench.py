"""Kernel microbenchmarks of the port: each kernel route beside its plain
torch version, µs per call.

The twin of the reference's ``benchmarks/kernels_bench.py``: the same
rows, shapes and data (numpy ``default_rng(0)``, drawn in the same
order) and the same keys. The reference's ``*_pallas_us`` keys time the
port's kernel route here: the hand-written CUDA kernel on the card, its
plain torch version on the CPU (a CPU time is no device time). Where
the rows differ:

  * the kernel routes take inputs already on the device, so their rows
    time the wrapper and its launch, not a host round trip (except
    ``aig_sim_pallas_us``, whose public route takes and returns numpy
    words, as the reference's does);
  * ``flash_ref_us`` times the port's plain ``attention_ref`` (the
    dense oracle over the same GQA heads); the reference times
    ``models.layers.full_attention``, which the port does not have yet;
  * ``aig_sim_walk_us`` is added: the walk kernel that replaces the
    reference's ``aig_sim_pallas``, beside the routed
    ``aig_sim_pallas_us``.

Times on the card come from CUDA events around a row's calls after a
warm-up, on the CPU from the host clock. ``run(sizes=...)`` takes other
shapes (``FULL`` is the reference's).

    python -m repro_torch.bench.kernels_bench [--device cpu]
        [--out BENCH_kernels_torch.json]

prints ``[kernels] name: value`` lines and writes JSON only with
``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import platform
import time
from types import SimpleNamespace
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of the bench rows (``FULL`` is the reference's)."""

    lut_layer: tuple = (256, 64, 64, 4, 4)      # B, n_in, N, K, L
    aig: tuple = (8, 4, 256)                    # n_vars, outputs, words
    lut_eval: tuple = (10, 4, 256)              # n_vars, outputs, words
    xnor: tuple = (256, 4096, 256)              # B, n, N
    fanin: tuple = (256, 4096, 1024, 8)         # B, n_in, N, K
    flash: tuple = (1, 1024, 4, 2, 64)          # B, S, H, KV, dh


FULL = Sizes()


def _random_aig(rng, n_vars: int, n_outs: int):
    from repro_torch.synth import AIG
    from repro_torch.synth.from_sop import table_to_aig
    aig = AIG(n_vars)
    aig.outputs = [table_to_aig(aig, rng.random(1 << n_vars) < 0.5, None,
                                [2 * (i + 1) for i in range(n_vars)])
                   for _ in range(n_outs)]
    return aig


def make_inputs(device: torch.device, sizes: Sizes = FULL):
    """Every row's inputs, drawn from ``default_rng(0)`` in the
    reference's order, as tensors on ``device`` (and the host arrays the
    host-facing routes take)."""
    from repro_torch.kernels.lut_eval import level_starts
    from repro_torch.synth import compile_device_plan, synthesize
    from repro_torch.synth.executor import _compile_plan, compile_tile_plan
    from repro_torch.synth.simulate import unpack_bits

    rng = np.random.default_rng(0)

    def dev(a, dtype=None):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        t = torch.as_tensor(a, device=device)
        return t.to(dtype) if dtype is not None else t

    i32, f32 = torch.int32, torch.float32
    B, n_in, N, K, L = sizes.lut_layer
    lut_layer = SimpleNamespace(
        codes=dev(rng.integers(0, L, (B, n_in)), i32),
        idx=dev(rng.integers(0, n_in, (N, K)), i32),
        tables=dev(rng.integers(0, L, (N, L ** K)), i32), L=L)

    n_vars, n_outs, n_words = sizes.aig
    aig = _random_aig(rng, n_vars, n_outs)
    f0, f1 = aig.fanin_arrays()
    words = rng.integers(0, 1 << 31, (n_vars, n_words)).astype(np.int32)
    aig_in = SimpleNamespace(aig=aig, f0=f0, f1=f1, n_pis=n_vars,
                             host_words=words.view(np.uint32),
                             words=dev(words), f0_t=dev(f0), f1_t=dev(f1))

    n_vars, n_outs, n_words = sizes.lut_eval
    mapped = synthesize(_random_aig(rng, n_vars, n_outs))
    plan = _compile_plan(mapped)
    dp = compile_device_plan(mapped, plan)
    tp = compile_tile_plan(plan, dp.n_pis, dp.k)
    lwords = rng.integers(0, 1 << 32, (n_vars, n_words), dtype=np.uint32)
    lut_eval = SimpleNamespace(
        mapped=mapped, plan=plan, dp=dp, tp=tp, host_words=lwords,
        words=dev(lwords), leaf_idx=dev(dp.leaf_idx), tt_bits=dev(dp.tt_bits),
        out_wires=dev(dp.out_wires), tt_tiles=dev(tp.tt_tiles),
        leaf_tiles=dev(tp.leaf_tiles), out_base=dev(tp.out_base),
        level_start=dev(level_starts(tp.level_of_tile)),
        bits=dev(unpack_bits(lwords, n_words * 32), i32),
        tt01=dev((dp.tt_bits & 1).astype(np.int32)))

    B, n, N = sizes.xnor
    xnor = SimpleNamespace(x=dev(rng.choice([-1.0, 1.0], (B, n)), f32),
                           w=dev(rng.choice([-1.0, 1.0], (N, n)), f32))

    B, n_in, N, K = sizes.fanin
    fanin = SimpleNamespace(
        x=dev(rng.normal(size=(B, n_in)), f32),
        idx=dev(rng.integers(0, n_in, (N, K)), i32),
        w=dev(rng.normal(size=(N, K)), f32),
        bias=torch.zeros((N,), dtype=f32, device=device))
    fanin.w_dense = dev(rng.normal(size=(N, n_in)), f32)

    b, s, h, kv, dh = sizes.flash
    flash = SimpleNamespace(q=dev(rng.normal(size=(b, s, h, dh)), f32),
                            k=dev(rng.normal(size=(b, s, kv, dh)), f32),
                            v=dev(rng.normal(size=(b, s, kv, dh)), f32))
    return SimpleNamespace(lut_layer=lut_layer, aig=aig_in,
                           lut_eval=lut_eval, xnor=xnor, fanin=fanin,
                           flash=flash)


def timer(device: torch.device) -> Callable[..., float]:
    """``t(fn, iters)``: µs per call of ``fn`` after one warm-up call,
    by CUDA events on the card and the host clock on the CPU."""
    def t(fn, iters: int = 20) -> float:
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e3 / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e6
    return t


def run(device: DeviceLike = None, sizes: Sizes = FULL) -> Dict[str, float]:
    """Every row of the reference's bench (plus ``aig_sim_walk_us``) on
    ``device`` (the card unless ``"cpu"``); returns name -> µs per call
    (``*_x`` rows are ratios)."""
    from repro_torch.kernels.aig_sim import aig_sim, aig_sim_ref, aig_sim_walk
    from repro_torch.kernels.fanin_matmul import fanin_matmul, fanin_matmul_ref
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.lut_eval import (lut_eval, lut_eval_gather_ref,
                                              lut_eval_ref, lut_eval_streamed)
    from repro_torch.kernels.lut_layer import lut_layer, lut_layer_ref
    from repro_torch.kernels.xnor_popcount import xnor_matmul, xnor_matmul_ref
    from repro_torch.synth.executor import execute_packed

    dev = resolve_device(device)
    inp = make_inputs(dev, sizes)
    t = timer(dev)

    out = {}
    a = inp.lut_layer
    out["lut_layer_ref_us"] = t(lambda: lut_layer_ref(a.codes, a.idx,
                                                      a.tables, a.L))
    out["lut_layer_pallas_us"] = t(lambda: lut_layer(a.codes, a.idx,
                                                     a.tables, a.L))

    a = inp.aig
    out["aig_sim_ref_us"] = t(lambda: aig_sim_ref(a.words, a.f0_t, a.f1_t,
                                                  a.n_pis), 3)
    out["aig_sim_pallas_us"] = t(lambda: aig_sim(a.host_words, a.f0, a.f1,
                                                 a.n_pis, device=dev), 3)
    out["aig_sim_walk_us"] = t(lambda: aig_sim_walk(a.words, a.f0_t,
                                                    a.f1_t))

    a = inp.lut_eval
    dp, tp = a.dp, a.tp
    out["lut_eval_numpy_us"] = t(lambda: execute_packed(
        a.mapped, a.host_words, plan=a.plan))
    out["lut_eval_ref_us"] = t(lambda: lut_eval_ref(
        a.words, a.leaf_idx, a.tt_bits, a.out_wires, n_wires=dp.n_wires))
    out["lut_eval_pallas_us"] = t(lambda: lut_eval(
        a.words, a.leaf_idx, a.tt_bits, a.out_wires, n_wires=dp.n_wires), 3)
    out["lut_eval_streamed_us"] = t(lambda: lut_eval_streamed(
        a.words, a.tt_tiles, a.leaf_tiles, a.out_base, a.level_start,
        n_rows=tp.n_rows), 5)
    out["lut_eval_streamed_vs_pallas_x"] = (
        out["lut_eval_streamed_us"] / out["lut_eval_pallas_us"])
    out["aig_sim_pallas_vs_ref_x"] = (
        out["aig_sim_pallas_us"] / out["aig_sim_ref_us"])
    out["lut_eval_gather_us"] = t(lambda: lut_eval_gather_ref(
        a.bits, a.leaf_idx, a.tt01, a.out_wires, dp.n_pis, dp.n_wires))

    a = inp.xnor
    out["xnor_ref_us"] = t(lambda: xnor_matmul_ref(a.x, a.w))
    out["xnor_pallas_us"] = t(lambda: xnor_matmul(a.x, a.w))

    a = inp.fanin
    out["fanin_ref_us"] = t(lambda: fanin_matmul_ref(a.x, a.idx, a.w,
                                                     a.bias))
    out["fanin_pallas_us"] = t(lambda: fanin_matmul(a.x, a.idx, a.w,
                                                    a.bias))
    out["fanin_dense_us"] = t(lambda: a.x @ a.w_dense.T)

    a = inp.flash
    out["flash_ref_us"] = t(lambda: attention_ref(a.q, a.k, a.v,
                                                  causal=True))
    out["flash_pallas_us"] = t(lambda: flash_attention(a.q, a.k, a.v), 3)

    for k, v in out.items():
        print(f"[kernels] {k}: {v:.1f}")
    return out


def device_meta(device: torch.device) -> Dict[str, object]:
    meta = {"torch": torch.__version__, "python": platform.python_version(),
            "device": str(device)}
    if device.type == "cuda":
        meta.update(card=torch.cuda.get_device_name(device),
                    n_devices=torch.cuda.device_count(),
                    cuda=torch.version.cuda)
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions (default: the card)")
    ap.add_argument("--out", default=None,
                    help="write the rows as JSON here "
                         "(BENCH_kernels_torch.json by convention)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = run(dev, FULL)
    if args.out:
        doc = {"section": "kernels", "meta": dict(device_meta(dev),
                                                  sizes=dataclasses.asdict(FULL)),
               "rows": [{"name": f"kernels/{k}", "us_per_call": v}
                        for k, v in rows.items()]}
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
