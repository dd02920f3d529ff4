"""NullaNet Tiny core, in torch: quantizer forwards, FCP masks, truth
tables, two-level minimization and logic-network inference.

    quant      — STE quantizers (sign/binary/PACT/signed/DoReFa),
                 per-layer activation selection, BN folding.
    fcp        — fanin-constrained pruning (masks, gradual + ADMM).
    truthtable — neuron -> truth-table enumeration (host).
    espresso   — two-level minimization (espresso-lite; numpy).
    lutcost    — the shared 6-LUT cost model.
    lutmap     — 6-LUT mapping + fmax/FF cost model, structural report.
    logic_infer— torch execution of compiled logic networks, hardware
                 report.
    netlist    — Verilog emission of a compiled network (pre- and
                 post-mapping).
"""
from . import (espresso, fcp, lutcost, lutmap, quant,  # noqa: F401
               truthtable)
from .logic_infer import (LogicNetwork, classify, compile_mlp_to_logic,  # noqa: F401
                          hardware_report, logic_layer_apply)
from .quant import ActQuantSpec, select_activation  # noqa: F401
