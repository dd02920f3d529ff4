"""repro_torch.core.netlist and synth.executor.emit_verilog against the
reference: the same network gives the same Verilog text, character for
character (pre-mapping layers and top module, the mapped netlist), and
``core.lutmap.structural_report`` gives the reference's report for
every ``effort`` and ``pipeline``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.synth as RS
import repro_torch.synth as PSY
from repro.core import quant as RQ
from repro.core.fcp import topk_row_mask as ref_topk_row_mask
from repro.core.logic_infer import LogicNetwork as RefLogicNetwork
from repro.core.lutmap import structural_report as ref_structural_report
from repro.core.netlist import emit_layer as ref_emit_layer
from repro.core.netlist import emit_mapped_network as ref_emit_mapped
from repro.core.netlist import emit_network as ref_emit_network
from repro.core.truthtable import extract_layer_tables as ref_extract
from repro_torch.core import quant as PQ
from repro_torch.core.logic_infer import LogicNetwork
from repro_torch.core.lutmap import structural_report
from repro_torch.core.netlist import (emit_layer, emit_mapped_network,
                                      emit_network)
from repro_torch.core.truthtable import extract_layer_tables


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    """(reference, port) LogicNetworks of the same weights: 8 inputs ->
    6 -> 4, fanin 3, signed 2-bit codes, 3-bit outputs."""
    rng = np.random.default_rng(3)
    widths, specs, alphas = [8, 6, 4], [("signed", 2), ("signed", 3)], \
        [0.9, 1.2]
    ref_layers, port_layers = [], []
    prev = ("signed", 2, 1.0)
    for i in range(2):
        w = rng.normal(size=(widths[i + 1], widths[i])).astype(np.float32)
        b = rng.normal(scale=0.3, size=widths[i + 1]).astype(np.float32)
        mask = np.array(ref_topk_row_mask(jnp.asarray(w), 3))
        ref_layers.append(ref_extract(
            jnp.asarray(w), jnp.asarray(b), mask, RQ.ActQuantSpec(*prev[:2]),
            RQ.ActQuantSpec(*specs[i]), prev[2], alphas[i], 3))
        port_layers.append(extract_layer_tables(
            w, b, mask, PQ.ActQuantSpec(*prev[:2]),
            PQ.ActQuantSpec(*specs[i]), prev[2], alphas[i], 3))
        np.testing.assert_array_equal(port_layers[-1].tables,
                                      np.asarray(ref_layers[-1].tables))
        prev = (*specs[i], alphas[i])
    return (RefLogicNetwork(ref_layers, RQ.ActQuantSpec("signed", 2), 1.0,
                            8, 4),
            LogicNetwork(port_layers, PQ.ActQuantSpec("signed", 2), 1.0, 8,
                         4))


def test_emit_layer_matches_reference(nets):
    ref, port = nets
    for i, (rl, pl) in enumerate(zip(ref.layers, port.layers)):
        text = emit_layer(pl, i)
        assert text == ref_emit_layer(rl, i)
        assert text.startswith(f"module layer{i} (") and "assign y[" in text


def test_emit_network_matches_reference(nets):
    ref, port = nets
    text = emit_network(port, name="jsc_top")
    assert text == ref_emit_network(ref, name="jsc_top")
    assert text.count("endmodule") == len(port.layers) + 1
    assert "always @(posedge clk) l1_q <= l1_y;" in text


@pytest.mark.parametrize("effort,verify", [(0, False), (1, False),
                                           (1, True)])
def test_emit_mapped_network_matches_reference(nets, effort, verify):
    ref, port = nets
    text = emit_mapped_network(port, effort=effort, verify=verify)
    assert text == ref_emit_mapped(ref, effort=effort, verify=verify)
    assert text.startswith("// nullanet_tiny_mapped: ")


def _random_mapped(synth, seed, n_vars, n_outs):
    rng = np.random.default_rng(seed)
    aig = synth.AIG(n_vars)
    aig.outputs = [synth.table_to_aig(aig, rng.random(1 << n_vars) < 0.5,
                                      None,
                                      [2 * (i + 1) for i in range(n_vars)])
                   for _ in range(n_outs)]
    return synth.synthesize(aig)


@pytest.mark.parametrize("seed,n_vars,n_outs", [(0, 8, 2), (1, 5, 3),
                                                (2, 9, 1)])
def test_emit_verilog_matches_reference(seed, n_vars, n_outs):
    port = _random_mapped(PSY, seed, n_vars, n_outs)
    text = PSY.emit_verilog(port, name="m")
    assert text == RS.emit_verilog(_random_mapped(RS, seed, n_vars, n_outs),
                                   name="m")
    assert text.count("_init = ") == port.n_luts > 0


def test_emit_verilog_constant_outputs_match_reference():
    """Outputs on the constant wire and a PI, inverted and not."""
    texts = []
    for synth in (RS, PSY):
        a = synth.AIG(3)
        a.outputs = [synth.CONST0, synth.CONST1, synth.lit(1) ^ 1]
        texts.append(synth.emit_verilog(synth.map_aig(a, k=4)))
    assert texts[1] == texts[0]
    assert "assign y[1] = 1'b1;" in texts[1]
    assert "assign y[2] = ~x[0];" in texts[1]


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("effort", [0, 1])
def test_structural_report_matches_reference(nets, effort, pipeline):
    """The repaired ``structural_report(net, effort, pipeline)``:
    ``effort`` rounds before mapping, no pipeline FFs when ``pipeline``
    is False; the report, per-layer reports and tag are the
    reference's."""
    ref, port = nets
    rep, per_layer, tag = structural_report(port, effort=effort,
                                            pipeline=pipeline)
    rrep, rper_layer, rtag = ref_structural_report(ref, effort=effort,
                                                   pipeline=pipeline)
    assert tag == rtag == "synth"
    assert dataclasses.astuple(rep) == dataclasses.astuple(rrep)
    assert [dataclasses.astuple(r) for r in per_layer] == \
        [dataclasses.astuple(r) for r in rper_layer]
    assert (rep.ffs == 0) == (not pipeline)
