"""Multi-level LUT mapping + retiming cost model (NullaNet Tiny step 5),
a copy of the reference's ``repro/core/lutmap.py`` (numpy only).

The paper hands minimized SOPs to Xilinx Vivado for multi-level logic
minimization, technology mapping to 6-input LUTs, and retiming, then
reports LUTs / FFs / fmax on a VU9P. Vivado is not available offline, so
this module provides an *analytic mapping model* with the same outputs:

  * LUT count  — structural covering of the SOP network into 6-LUTs with
    support-aware collapsing (a function whose total support <= 6 is one
    LUT regardless of SOP size).
  * logic depth — LUT levels on the critical path.
  * fmax      — 1 / (t_ff + depth * t_level); calibrated on VU9P-class
    numbers so that a depth-1 network hits ~2.08 GHz (the paper's JSC-S
    reports 2,079 MHz, i.e. single-level logic between FFs).
  * FFs       — retiming model: one pipeline register per layer output
    code bit (+ input register stage).

Absolute numbers are a model of an FPGA, not a time on any device.
``structural_report`` measures the mapping instead, through the host
synthesis of ``repro_torch.synth``.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .espresso import Cover, FREE
# the cost model (LUT width, timing, MapReport, tree/RAM LUT counts) is
# shared with synth.lutmap via core.lutcost — single definition site
from .lutcost import (LUT_K, T_FF_NS, T_LEVEL_NS,  # noqa: F401 (re-export)
                      MapReport, logicnets_lut_cost,
                      tree_lut_cost as _tree)


def map_cover(cover: Cover) -> MapReport:
    """Map one single-output SOP cover to 6-LUTs.

    Strategy mirroring a technology mapper:
      1. If the function's true support fits in one LUT -> 1 LUT, depth 1.
      2. Else: each cube is an AND tree over its literals; cubes that fit
         together (combined support <= 6) get packed into shared LUTs via
         first-fit-decreasing on support; the OR tree combines cube
         outputs, absorbing cube ANDs into OR LUTs when slack allows.
    """
    if cover.n_cubes == 0:
        return MapReport(0, 0, 0)  # constant
    support = cover.support()
    s = int(support.sum())
    if s == 0:
        return MapReport(0, 0, 0)  # constant
    if s <= LUT_K:
        return MapReport(1, 1, 0)
    # A real mapper never does worse than the RAM-style decomposition of
    # the raw s-input function (LUT6 + mux tree); take min(SOP tree, RAM).
    ram = logicnets_lut_cost(s, 1)

    # per-cube AND trees
    total_luts = 0
    and_depths = []
    cube_sizes = sorted(
        (int(np.sum(c != FREE)) for c in cover.cubes), reverse=True)

    # First-fit-decreasing packing: cubes with combined literal count <= 6
    # can share a LUT producing the OR of those small products.
    bins: List[int] = []   # remaining capacity of each shared (AND+OR) LUT
    or_inputs = 0
    for sz in cube_sizes:
        if sz >= LUT_K:
            luts, depth = _tree(sz)
            total_luts += luts
            and_depths.append(depth)
            or_inputs += 1
            continue
        placed = False
        for i, cap in enumerate(bins):
            if sz <= cap:
                bins[i] = cap - sz
                placed = True
                break
        if not placed:
            bins.append(LUT_K - sz)
            or_inputs += 1
    total_luts += len(bins)
    if bins:
        and_depths.append(1)

    or_luts, or_depth = _tree(or_inputs)
    total_luts += or_luts
    depth = (max(and_depths) if and_depths else 0) + or_depth
    sop = MapReport(total_luts, max(depth, 1), 0)
    if ram.luts < sop.luts:
        return ram
    return sop


def map_neuron(covers: Sequence[Cover]) -> MapReport:
    """A neuron with a b-bit output is b independent Boolean functions."""
    rep = MapReport(0, 0, 0)
    for c in covers:
        rep = rep + map_cover(c)
    return rep


def map_layer(neuron_reports: Sequence[MapReport], out_bits_total: int,
              pipeline: bool = True) -> MapReport:
    """Aggregate neurons of one layer; retiming inserts one FF stage per
    layer output bit (the paper's 'retiming' knob)."""
    rep = MapReport(0, 0, 0)
    for r in neuron_reports:
        rep = rep + r
    ffs = out_bits_total if pipeline else 0
    return MapReport(rep.luts, rep.depth, rep.ffs + ffs)


def map_network(layer_reports: Sequence[MapReport]) -> MapReport:
    """Whole-network totals. Depth model: with per-layer pipelining
    (retiming), fmax is set by the *deepest single layer*, and latency is
    n_layers cycles; report depth = max layer depth."""
    luts = sum(r.luts for r in layer_reports)
    ffs = sum(r.ffs for r in layer_reports)
    depth = max((r.depth for r in layer_reports), default=0)
    return MapReport(luts, depth, ffs)


def latency_ns(network: MapReport, n_stages: int) -> float:
    """Pipelined latency = stages / fmax."""
    return n_stages * 1e3 / network.fmax_mhz


# ---------------------------------------------------------------------------
# Structural (measured) mapping via repro_torch.synth — analytic fallback
# ---------------------------------------------------------------------------

def structural_report(net, effort: int = 1, pipeline: bool = True):
    """Measured per-layer 6-LUT mapping of a compiled ``LogicNetwork``.

    Runs the synthesis pipeline on the host (SOP -> AIG -> balance/
    rewrite -> FlowMap-style 6-LUT mapping, ``repro_torch.synth``) on
    every layer (``effort`` balance/rewrite rounds) and aggregates with
    the same retiming/FF model as the analytic path, so the two reports
    are directly comparable; ``pipeline=False`` counts no pipeline FFs.
    Returns ``(MapReport, per_layer, "synth")``; on any synthesis
    failure falls back to the analytic estimate and tags it
    ``"analytic"``.
    """
    try:
        from repro_torch.synth import layer_to_aig, synthesize

        per_layer = []
        for lt in net.layers:
            mapped = synthesize(layer_to_aig(lt), effort=effort, k=LUT_K)
            out_bits_total = lt.out_spec.code_bits * lt.n_neurons
            ffs = out_bits_total if pipeline else 0
            per_layer.append(mapped.report(ffs))
        return map_network(per_layer), per_layer, "synth"
    except Exception as e:
        # loudly: downstream reports tag the backend, but a silent switch
        # from measured to modeled numbers must not pass unnoticed
        import warnings
        warnings.warn(f"repro_torch.synth structural mapping failed ({e!r}); "
                      "falling back to the analytic cost model")
        from .logic_infer import hardware_report
        rep, per_layer = hardware_report(net, minimize_logic=True)
        return rep, per_layer, "analytic"
