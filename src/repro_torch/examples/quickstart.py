"""Quickstart: the full NullaNet Tiny flow in ~60 lines.

Train a JSC MLP with QAT (per-layer activation selection) + FCP, compile
every neuron into fixed-function combinational logic, verify the logic
network is bit-exact vs the quantized model, and report the mapped
hardware cost (LUTs / FFs / fmax) vs the LogicNets-style baseline.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

It trains on the card unless ``--device cpu`` is given, and writes the
Verilog netlist to ``nullanet_tiny.v`` in the temporary directory.
"""
import argparse
import os
import tempfile

import torch

from repro_torch.configs.jsc import JSC_DEMO
from repro_torch.core.logic_infer import hardware_report
from repro_torch.core.netlist import emit_network
from repro_torch.data.jsc import train_test
from repro_torch.device import resolve_device
from repro_torch.models.mlp import mlp_forward, to_logic
from repro_torch.train.jsc_trainer import train_jsc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    dev = resolve_device(ap.parse_args(argv).device)
    # a reduced JSC so the demo runs in ~a minute on CPU
    cfg = JSC_DEMO
    data = train_test(8000, 2000, seed=0)

    print("1) QAT + fanin-constrained-pruning training ...")
    res = train_jsc(cfg, steps=500, data=data, device=dev)
    print(f"   test accuracy: {res.test_acc:.4f} "
          f"(float reference: {res.float_test_acc:.4f})")

    print("2) compiling neurons to truth tables (MAC+BN+act -> logic) ...")
    net = to_logic(cfg, res.model)

    print("3) verifying bit-exact equivalence on the test set ...")
    x = torch.from_numpy(data[1][0][:1000]).to(dev)
    pred_mlp = torch.argmax(mlp_forward(cfg, res.model, x)[:, :5], -1)
    pred_logic = torch.argmax(net(x)[:, :5], -1)
    if not torch.equal(pred_mlp, pred_logic):
        raise SystemExit("logic network diverged!")
    print("   bit-exact: OK")

    print("4) two-level minimization + 6-LUT mapping ...")
    mini, _ = hardware_report(net, minimize_logic=True)
    base, _ = hardware_report(net, minimize_logic=False)
    print(f"   NullaNet Tiny : {mini.luts:5d} LUTs  {mini.ffs:4d} FFs  "
          f"fmax {mini.fmax_mhz:7.1f} MHz")
    print(f"   LogicNets-ish : {base.luts:5d} LUTs  {base.ffs:4d} FFs  "
          f"fmax {base.fmax_mhz:7.1f} MHz")
    print(f"   -> {base.luts / max(mini.luts, 1):.2f}x fewer LUTs")

    path = os.path.join(tempfile.gettempdir(), "nullanet_tiny.v")
    print(f"5) emitting Verilog netlist -> {path}")
    with open(path, "w") as f:
        f.write(emit_network(net))
    print("done.")


if __name__ == "__main__":
    main()
