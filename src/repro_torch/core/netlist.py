"""Netlist emission: fixed-function combinational logic as Verilog text.

Two emission styles, matching the two ends of the synthesis flow:

  * ``emit_network`` — pre-mapping: one structural module per logic
    layer with SOP assigns from the espresso'd covers, plus a top module
    wiring layers through pipeline registers (the retiming stage). This
    is what a user would hand to Vivado.
  * ``emit_mapped_network`` — post-mapping: the ``repro_torch.synth``
    pipeline (AIG -> rewrite -> 6-LUT map) is run here, and the *mapped*
    LUT netlist is emitted — the artifact Vivado would have produced,
    now measured instead of modeled.

Either way the text doubles as a human-auditable dump of the compiled
Boolean functions. A copy of the reference's ``repro/core/netlist.py``
(numpy only): for the same network the text is the reference's, its
"generated by" header lines included.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .espresso import Cover, cover_to_sop_str, minimize
from .logic_infer import LogicNetwork, _bitexpand
from .truthtable import onset_of


def emit_layer(lt, layer_id: int) -> str:
    in_bits = lt.in_spec.code_bits
    out_bits = lt.out_spec.code_bits
    lines = [
        f"module layer{layer_id} (",
        f"  input  wire [{in_bits * _max_input(lt) - 1}:0] x,",
        f"  output wire [{out_bits * lt.n_neurons - 1}:0] y",
        ");",
    ]
    for j in range(lt.n_neurons):
        table = np.asarray(lt.tables[j])
        var_names = []
        for k in range(lt.fanin):
            src = int(lt.fanin_idx[j, k])
            for b in range(in_bits):
                var_names.append(f"x[{src * in_bits + b}]")
        for ob in range(out_bits):
            onset, dc = _bitexpand(onset_of(table, ob), lt, in_bits)
            cov = minimize(onset, dc)
            sop = cover_to_sop_str(cov, var_names)
            if cov.n_cubes and np.all(cov.cubes == 2):
                sop = "1'b1"
            lines.append(f"  assign y[{j * out_bits + ob}] = {sop};")
    lines.append("endmodule")
    return "\n".join(lines)


def _max_input(lt) -> int:
    return int(np.max(lt.fanin_idx)) + 1


def emit_network(net: LogicNetwork, name: str = "nullanet_tiny") -> str:
    """Full structural Verilog: layers + pipeline FFs between them."""
    parts: List[str] = [f"// {name}: fixed-function combinational logic",
                        f"// generated by repro.core.netlist"]
    for i, lt in enumerate(net.layers):
        parts.append(emit_layer(lt, i))

    in_bits0 = net.in_spec.code_bits
    top = [
        f"module {name} (",
        "  input  wire clk,",
        f"  input  wire [{in_bits0 * net.n_inputs - 1}:0] x_in,",
    ]
    last = net.layers[-1]
    top.append(
        f"  output reg  [{last.out_spec.code_bits * last.n_neurons - 1}:0] y_out")
    top.append(");")
    prev = "x_in"
    for i, lt in enumerate(net.layers):
        ob = lt.out_spec.code_bits * lt.n_neurons
        top.append(f"  wire [{ob - 1}:0] l{i}_y;")
        top.append(f"  reg  [{ob - 1}:0] l{i}_q;")
        top.append(f"  layer{i} u{i} (.x({prev}), .y(l{i}_y));")
        top.append(f"  always @(posedge clk) l{i}_q <= l{i}_y;  // retiming stage")
        prev = f"l{i}_q"
    top.append(f"  always @(posedge clk) y_out <= {prev};")
    top.append("endmodule")
    parts.append("\n".join(top))
    return "\n\n".join(parts)


def emit_mapped_network(net: LogicNetwork, name: str = "nullanet_tiny_mapped",
                        effort: int = 1, verify=False) -> str:
    """Post-synthesis Verilog: the whole network flattened, optimized and
    technology-mapped to 6-LUTs by ``repro_torch.synth``, emitted as one
    combinational module of INIT-indexed LUT assigns. ``verify=True``
    miters every synthesis stage (``repro_torch.check``) before emitting;
    ``verify="formal"`` escalates wide cones to SAT proofs
    (``repro_torch.check.sat``) instead of sampling them."""
    from repro_torch.synth import emit_verilog, network_to_aig, synthesize

    return emit_verilog(
        synthesize(network_to_aig(net), effort=effort, verify=verify), name)
