"""Inference latency: compiled-logic path vs dense float vs XNOR path,
the twin of the reference's ``benchmarks/latency.py``.

The paper's headline is ultra-low latency. On the FPGA that is the LUT
pipeline (modelled in ``table1_jsc``); here the execution paths run on
the card at batch 256 (JSC-S trained with the port's ``train_jsc``,
compiled with ``to_logic``, the first ``batch`` test rows on the
device), with the reference's keys:

  ``logic_us``         ``net(x)``: the table gather (the reference's own
                       path outside any kernel);
  ``logic_pallas_us``  ``net(x, use_kernel=True)``: the ``lut_layer``
                       kernel, one launch a layer;
  ``dense_float_us``   a float32 relu MLP of the same topology, TF32 off,
                       weights from ``np.random.default_rng(seed)``;
  ``xnor_us``          ``xnor_matmul(sign(x), sign(w0))`` on the first
                       layer (``xnor_popcount``);

and one row the reference lacks, ``bitplane_streamed_us``: the path
users are served through, ``compile_logic_network(net,
engine="cuda-streamed").classify(x, 5)`` at the geometry that engine
takes (``bitplane_streamed_tile``).

Each path is timed two ways: ``<path>_us`` is host wall µs, the
reference's way (``perf_counter`` around 50 back-to-back calls, then a
synchronize); ``<path>_device_us`` is CUDA events around 10 calls
queued behind a device spin (``repro_torch.timing``), with
``device_queued[path]`` false where a call waits for the device itself
and the spin ran out (then the events time the host too); on the CPU
both are ``None`` (no device to queue behind). Back-to-back
calls on the card time the host's issue rate, hence both. The record
carries ``device_info`` (``backend``, the card's name, its power limit)
and ``identical``: the kernel paths against their plain counterparts on
the same inputs (lut_layer against the gather, xnor against
``xnor_matmul_ref``, the streamed labels against ``classify``).

    PYTHONPATH=src python -m repro_torch.bench.latency [--device cpu]
        [--steps N] [--batch B] [--seed S] [--out BENCH_latency_torch.json]

It writes JSON only with ``--out`` (or ``run(..., out=PATH)``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.data.jsc import N_CLASSES, train_test
from repro_torch.device import device_info, resolve_device
from repro_torch.timing import device_us, wall_us

ITERS = 50                  # the reference's _time_call iterations
# calls queued behind the spin for device µs: few enough that their
# launches (up to some 25 a call) stay well inside the card's queue of
# pending launches, which blocks the host once full
DEVICE_ITERS = 10
PATHS = ("logic", "logic_pallas", "dense_float", "xnor", "bitplane_streamed")

# the inputs and networks of the last ``run`` (its paths' operands), so a
# caller can hold the kernel paths against their plain versions on them
last_run: Optional[SimpleNamespace] = None


@contextlib.contextmanager
def _tf32(enabled: bool):
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = enabled
    try:
        yield
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def dense_weights(cfg, seed: int = 0) -> List[np.ndarray]:
    """(out, in) float32 weights of a dense MLP of ``cfg``'s topology,
    standard normal from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((o, i)).astype(np.float32)
            for i, o in zip((cfg.n_inputs,) + tuple(cfg.features),
                            cfg.features)]


def dense_forward(x: torch.Tensor, ws) -> torch.Tensor:
    """relu(h @ w.T) layer by layer (the reference's ``dense_fn``)."""
    h = x
    for w in ws:
        h = torch.relu(h @ w.T)
    return h


def run(steps: int = 600, batch: int = 256, device=None, seed: int = 0,
        out: Optional[str] = None) -> Dict:
    """Train JSC-S, compile it and time the five paths on ``device``
    (the card unless ``"cpu"``, where the kernels' plain versions run
    and every time is the host's); returns the record."""
    global last_run
    from repro_torch.configs.jsc import JSC
    from repro_torch.core.logic_infer import classify
    from repro_torch.kernels.xnor_popcount import xnor_matmul, xnor_matmul_ref
    from repro_torch.models.mlp import to_logic
    from repro_torch.synth import compile_logic_network
    from repro_torch.train.jsc_trainer import train_jsc

    dev = resolve_device(device)
    cfg = JSC["jsc-s"]
    data = train_test(10000, 2000)
    res = train_jsc(cfg, steps=steps, data=data, seed=seed, device=dev)
    net = to_logic(cfg, res.model)
    x = torch.as_tensor(data[1][0][:batch], device=dev)
    ws = [torch.as_tensor(w, device=dev) for w in dense_weights(cfg, seed)]
    wq = torch.sign(ws[0])
    bitnet = compile_logic_network(net, engine="cuda-streamed", device=dev)
    tile = bitnet.executor.spec.tile

    fns = {
        "logic": lambda: net(x),
        "logic_pallas": lambda: net(x, use_kernel=True),
        "dense_float": lambda: dense_forward(x, ws),
        "xnor": lambda: xnor_matmul(torch.sign(x), wq),
        "bitplane_streamed": lambda: bitnet.classify(x, N_CLASSES),
    }
    out_rec: Dict = {}
    queued: Dict[str, Optional[bool]] = {}
    with _tf32(False):
        for name in PATHS:
            out_rec[f"{name}_us"] = wall_us(fns[name], dev, ITERS)
            # on the CPU there is no device to queue behind: not measured
            out_rec[f"{name}_device_us"], queued[name] = (
                device_us(fns[name], dev, DEVICE_ITERS)
                if dev.type == "cuda" else (None, None))
    out_rec["batch"] = batch
    out_rec["logic_vs_dense_x"] = round(out_rec["dense_float_us"]
                                        / out_rec["logic_us"], 2)

    with torch.no_grad():
        codes = net.apply_codes(net.quantize_inputs(x))
        kcodes = net.apply_codes(net.quantize_inputs(x), use_kernel=True)
        labels = classify(net, x, N_CLASSES).cpu().numpy()
        sx = torch.sign(x)
        out_rec["identical"] = {
            "logic_pallas": bool(torch.equal(kcodes, codes)),
            "xnor": bool(torch.equal(xnor_matmul(sx, wq),
                                     xnor_matmul_ref(sx, wq))),
            "bitplane_streamed": bool(np.array_equal(
                bitnet.classify(x, N_CLASSES), labels)),
        }
    out_rec["device_queued"] = queued
    out_rec["bitplane_streamed_tile"] = [tile.tile_rows, tile.block_w]
    # nested, so the regression gate does not read them as timings
    out_rec["train"] = {"steps": steps, "seed": seed,
                        "test_acc": res.test_acc}
    out_rec.update(device_info(dev))
    last_run = SimpleNamespace(net=net, x=x, ws=ws, wq=wq, bitnet=bitnet,
                               cfg=cfg, model=res.model)
    for k, v in out_rec.items():
        if k.endswith("_us") and v is not None:
            print(f"[latency] {k}: {v:.1f}")
    print(f"[latency] identical {out_rec['identical']}, queued behind the "
          f"spin {queued} on {out_rec['device']} "
          f"({out_rec['power_limit']})")
    if out:
        from repro_torch.bench.meta import bench_meta
        with open(out, "w") as f:
            json.dump({"section": "latency",
                       "meta": bench_meta(seed=seed, device=dev),
                       "results": out_rec}, f, indent=1)
    return out_rec


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.latency")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--steps", type=int, default=600,
                    help="QAT + FCP steps (the reference's)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, metavar="JSON",
                    help="write the record here (nothing is written "
                         "without it)")
    args = ap.parse_args(argv)
    return run(args.steps, args.batch, args.device, args.seed, args.out)


if __name__ == "__main__":
    main()
