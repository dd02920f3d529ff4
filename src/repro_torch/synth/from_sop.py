"""SOP -> AIG construction: espresso `Cover`s become AND/OR trees.

Bridges the paper's two-level minimization (repro_torch.core.espresso) into
the multi-level flow: each cube is an AND tree over its literals, cubes
join in an OR tree, and both trees are built level-aware so the initial
AIG is already depth-balanced. ``network_to_aig`` flattens a whole
compiled ``LogicNetwork`` (truth tables per neuron output bit, with
unreachable input codes as don't-cares) into one combinational AIG whose
PIs/POs are the bit-level wires of the input/output code planes.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.espresso import FREE, Cover, minimize

from .aig import AIG, lit_not


def cover_to_aig(aig: AIG, cover: Cover, in_lits: Sequence[int]) -> int:
    """Build the SOP realised by ``cover`` over existing literals; returns
    the output literal. ``in_lits[v]`` is the literal of SOP variable v."""
    assert len(in_lits) == cover.n_vars
    cube_lits: List[int] = []
    for cube in cover.cubes:
        lits = []
        for v in range(cover.n_vars):
            if cube[v] == FREE:
                continue
            lits.append(in_lits[v] if cube[v] == 1 else lit_not(in_lits[v]))
        cube_lits.append(aig.and_many(lits))
    return aig.or_many(cube_lits)


# beyond this many SOP literals a flat two-level form is likely worse
# than Shannon decomposition (the multi-level analogue of the LUT-RAM
# mux-tree a real mapper falls back to for unstructured functions)
_SOP_LIMIT = 48


def minimize_both_phases(onset: np.ndarray, dc: Optional[np.ndarray] = None
                         ):
    """Minimize a function and its complement; return ``(cover,
    inverted)`` for whichever phase is cheaper (fewer literals, then
    fewer cubes). Inversion is free on an AIG edge, so builders always
    want the cheap phase."""
    onset = np.asarray(onset, bool)
    dc_arr = None if dc is None else np.asarray(dc, bool)
    pos = minimize(onset, dc_arr)
    neg_on = ~onset if dc_arr is None else (~onset & ~dc_arr)
    neg = minimize(neg_on, dc_arr)
    if (neg.n_literals, neg.n_cubes) < (pos.n_literals, pos.n_cubes):
        return neg, True
    return pos, False


def table_to_aig(aig: AIG, onset: np.ndarray, dc: Optional[np.ndarray],
                 in_lits: Sequence[int]) -> int:
    """Minimize a dense on-set (+ optional DC set) and build multi-level
    logic for it.

    Small covers become flat SOPs in whichever phase (function or
    complement) is cheaper — inversion is free on the AIG edge. Covers
    past ``_SOP_LIMIT`` literals are split by Shannon cofactoring on the
    most balanced variable and rebuilt as a mux of two recursive halves,
    which keeps unstructured (near-random) functions mappable."""
    onset = np.asarray(onset, bool)
    n_vars = len(in_lits)
    dc_arr = None if dc is None else np.asarray(dc, bool)
    cov, inv = minimize_both_phases(onset, dc_arr)
    if cov.n_literals > _SOP_LIMIT and n_vars > 6:
        care = np.ones_like(onset) if dc_arr is None else ~dc_arr
        idx = np.nonzero(care & onset)[0]
        # split on the variable whose cofactors are most balanced
        ones = np.array([int(np.sum((idx >> v) & 1)) for v in range(n_vars)])
        v = int(np.argmin(np.abs(ones - len(idx) / 2)))
        rows = np.arange(onset.shape[0])
        lo, hi = ((rows >> v) & 1) == 0, ((rows >> v) & 1) == 1
        rest = list(in_lits[:v]) + list(in_lits[v + 1:])
        f0 = table_to_aig(aig, onset[lo],
                          None if dc_arr is None else dc_arr[lo], rest)
        f1 = table_to_aig(aig, onset[hi],
                          None if dc_arr is None else dc_arr[hi], rest)
        return aig.mux(in_lits[v], f1, f0)
    res = cover_to_aig(aig, cov, in_lits)
    return lit_not(res) if inv else res


def _layer_wires_to_aig(aig: AIG, lt, wires: Sequence[int]) -> List[int]:
    """Synthesize one ``LayerTables`` layer: ``wires`` are the literals of
    the input code bit-plane; returns the output bit-plane literals."""
    from repro_torch.core.logic_infer import _bitexpand
    from repro_torch.core.truthtable import onset_of

    in_bits = lt.in_spec.code_bits
    out_bits = lt.out_spec.code_bits
    out_wires: List[int] = []
    for j in range(lt.n_neurons):
        in_lits = []
        for k in range(lt.fanin):
            src = int(lt.fanin_idx[j, k])
            for b in range(in_bits):
                in_lits.append(wires[src * in_bits + b])
        table = np.asarray(lt.tables[j])
        for ob in range(out_bits):
            onset, dc = _bitexpand(onset_of(table, ob), lt, in_bits)
            out_wires.append(table_to_aig(aig, onset, dc, in_lits))
    return out_wires


def layer_to_aig(lt, n_in: Optional[int] = None) -> AIG:
    """One logic layer as a standalone AIG (PIs = input code bits)."""
    if n_in is None:
        n_in = int(np.max(lt.fanin_idx)) + 1
    in_bits = lt.in_spec.code_bits
    aig = AIG(n_in * in_bits)
    wires = [2 * (p + 1) for p in range(n_in * in_bits)]
    aig.outputs = _layer_wires_to_aig(aig, lt, wires)
    return aig


def network_to_aig(net) -> AIG:
    """Flatten a compiled ``LogicNetwork`` into one combinational AIG.

    PI i*in_bits+b is bit b of input code i; PO j*out_bits+ob is bit ob of
    the last layer's neuron j output code. Layer boundaries disappear —
    this is the representation the mapper covers and the bitplane
    executor runs."""
    in_bits0 = net.in_spec.code_bits
    aig = AIG(net.n_inputs * in_bits0)
    wires: List[int] = [2 * (p + 1) for p in range(net.n_inputs * in_bits0)]
    for lt in net.layers:
        wires = _layer_wires_to_aig(aig, lt, wires)
    aig.outputs = list(wires)
    return aig
