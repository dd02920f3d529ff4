"""NullaNet Tiny core, in torch: quantizer forwards, FCP masks, truth
tables, two-level minimization and logic-network inference.

    quant      — quantizer forward passes, per-layer activation
                 selection, BN folding.
    fcp        — fanin-constrained pruning masks.
    truthtable — neuron -> truth-table enumeration (host).
    espresso   — two-level minimization (espresso-lite; numpy).
    lutcost    — the shared 6-LUT cost model.
    logic_infer— torch execution of compiled logic networks.
"""
from . import espresso, fcp, lutcost, quant, truthtable  # noqa: F401
from .logic_infer import (LogicNetwork, classify, compile_mlp_to_logic,  # noqa: F401
                          logic_layer_apply)
from .quant import ActQuantSpec, select_activation  # noqa: F401
