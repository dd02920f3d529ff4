"""repro_torch.synth against repro.synth: the copied host pipeline
(SOP -> AIG -> rewrite -> 6-LUT map) and the plan compilers give the
same mapped netlists and the same plan tensors, exactly."""
import functools

import numpy as np
import pytest

import repro.synth as ref_synth
import repro_torch.synth as port_synth
from repro.synth.executor import _compile_plan as ref_compile_plan
from repro.synth.from_sop import table_to_aig as ref_table_to_aig
from repro_torch.synth.executor import _compile_plan as port_compile_plan
from repro_torch.synth.from_sop import table_to_aig as port_table_to_aig


def _aigs(seed, n_vars, n_outs, density=0.5):
    """The same random tables as an AIG of each package."""
    rng = np.random.default_rng(seed)
    tables = [rng.random(1 << n_vars) < density for _ in range(n_outs)]
    out = []
    for synth, t2a in ((ref_synth, ref_table_to_aig),
                       (port_synth, port_table_to_aig)):
        aig = synth.AIG(n_vars)
        aig.outputs = [t2a(aig, t, None, [2 * (i + 1) for i in range(n_vars)])
                       for t in tables]
        out.append(aig)
    return out


@functools.lru_cache(maxsize=None)
def _mapped_pair(seed, n_vars, n_outs, effort=1):
    """(reference, port) mapped netlists of the same random tables."""
    ref_aig, port_aig = _aigs(seed, n_vars, n_outs)
    assert (ref_aig.n_nodes, ref_aig.outputs) == \
        (port_aig.n_nodes, port_aig.outputs)
    return (ref_synth.synthesize(ref_aig, effort=effort),
            port_synth.synthesize(port_aig, effort=effort))


def _same_mapped(a, b):
    assert (a.n_pis, a.k, a.outputs) == (b.n_pis, b.k, b.outputs)
    assert [(l.root, l.leaves, l.tt) for l in a.luts] == \
        [(l.root, l.leaves, l.tt) for l in b.luts]


@pytest.mark.parametrize("seed,n_vars,n_outs,effort", [
    (0, 8, 2, 1), (4, 9, 2, 1), (1, 8, 3, 0), (2, 7, 2, 2)])
def test_synthesize_matches_reference(seed, n_vars, n_outs, effort):
    ref, port = _mapped_pair(seed, n_vars, n_outs, effort)
    assert port.n_luts > 1
    _same_mapped(ref, port)
    assert port.depth == ref.depth


@pytest.mark.parametrize("tile_rows", [8, 32])
def test_plans_match_reference(tile_rows):
    ref, port = _mapped_pair(4, 9, 2, 1)
    rdp = ref_synth.compile_device_plan(ref, tile_rows=tile_rows)
    pdp = port_synth.compile_device_plan(port, tile_rows=tile_rows)
    for f in ("leaf_idx", "tt_bits", "out_wires", "out_idx", "out_neg"):
        a, b = getattr(rdp, f), getattr(pdp, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (rdp.n_pis, rdp.n_wires, rdp.k) == (pdp.n_pis, pdp.n_wires, pdp.k)
    rt, pt = rdp.tiles, pdp.tiles
    for f in ("tt_tiles", "leaf_tiles", "leaf_loc", "gather_rows",
              "out_base", "level_of_tile", "out_idx", "out_neg",
              "row_of_wire"):
        a, b = getattr(rt, f), getattr(pt, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (rt.n_pis, rt.n_rows, rt.tile_rows, rt.gather_cap, rt.k) == \
        (pt.n_pis, pt.n_rows, pt.tile_rows, pt.gather_cap, pt.k)
    if tile_rows == 8:
        assert pt.n_tiles > pdp.n_levels     # levels really split


def test_constant_network_plans():
    ref_aig, port_aig = (ref_synth.AIG(3), port_synth.AIG(3))
    ref_aig.outputs = port_aig.outputs = [1]
    ref, port = ref_synth.synthesize(ref_aig), port_synth.synthesize(port_aig)
    assert ref.n_luts == port.n_luts == 0
    rp, pp = ref_compile_plan(ref), port_compile_plan(port)
    np.testing.assert_array_equal(rp.out_idx, pp.out_idx)
    np.testing.assert_array_equal(rp.out_neg, pp.out_neg)
    pt = port_synth.compile_tile_plan(pp, 3, port.k, 8)
    assert pt.n_tiles == 0 and pt.n_rows == 4


def test_simulate_and_packing_match_reference():
    ref_aig, port_aig = _aigs(3, 7, 2)
    words = ref_synth.random_words(7, 5, seed=1)
    np.testing.assert_array_equal(port_synth.random_words(7, 5, seed=1),
                                  words)
    np.testing.assert_array_equal(ref_synth.simulate(ref_aig, words),
                                  port_synth.simulate(port_aig, words))
    np.testing.assert_array_equal(ref_synth.input_patterns(7),
                                  port_synth.input_patterns(7))
    bits = np.random.default_rng(0).integers(0, 2, (5, 77))
    np.testing.assert_array_equal(ref_synth.pack_bits(bits),
                                  port_synth.pack_bits(bits))
    np.testing.assert_array_equal(
        port_synth.unpack_bits(port_synth.pack_bits(bits), 77), bits)
