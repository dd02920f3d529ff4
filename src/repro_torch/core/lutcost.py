"""Shared 6-LUT cost model — the single source of truth for LUT width,
timing constants, and the cost/report datatypes used by *both* mappers.

``core.lutmap`` (the analytic Vivado-style estimate) and
``synth.lutmap`` (the measured FlowMap-style cover) must report through
the same ``MapReport`` with the same ``LUT_K``/timing constants, or
their depth/area/fmax numbers silently drift apart. Everything they
share lives here; ``repro.check``'s duplicate-definition lint keeps a
second copy from ever reappearing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

LUT_K = 6                # Xilinx UltraScale+ native LUT width
T_LEVEL_NS = 0.25        # per-LUT-level logic+routing delay (VU9P-class)
T_FF_NS = 0.231          # clk->q + setup;  depth1 -> 1/(0.481ns) = 2.079 GHz


@dataclasses.dataclass
class MapReport:
    luts: int
    depth: int           # LUT levels
    ffs: int

    @property
    def fmax_mhz(self) -> float:
        if self.depth <= 0:
            return 1e3 / T_FF_NS
        return 1e3 / (T_FF_NS + self.depth * T_LEVEL_NS)

    def __add__(self, other: "MapReport") -> "MapReport":
        return MapReport(self.luts + other.luts,
                         max(self.depth, other.depth),
                         self.ffs + other.ffs)


def tree_lut_cost(n: int, k: int = LUT_K) -> Tuple[int, int]:
    """(luts, depth) of a balanced k-ary tree combining n signals with an
    associative gate. n <= 1 is free."""
    if n <= 1:
        return 0, 0
    luts, depth = 0, 0
    while n > 1:
        groups = math.ceil(n / k)
        luts += groups
        depth += 1
        n = groups
    return luts, depth


def logicnets_lut_cost(fanin_bits: int, out_bits: int) -> MapReport:
    """LogicNets maps each neuron's *entire* (fanin_bits -> out_bits) truth
    table to a LUT cascade without two-level minimization. Standard RAM-
    style decomposition: a b-output, n-input table costs
    b * 2^(n-6) (wait... ) — we use the Xilinx LUT6 count for an n-input
    1-output function: L(n) = 1 for n<=6 else 2*L(n-1)... that explodes;
    real mappers use L(n) = ceil((2^(n-4)-1)/3)-ish MUX trees. We model
    the published LogicNets heuristic: L(n) ~ (2^(n-4) - 1) / 3 * 2 + 1
    for n > 6, i.e. a F7/F8-mux LUT tree, clamped at >= 1.
    """
    if fanin_bits <= LUT_K:
        per_bit, depth = 1, 1
    else:
        # LUT6 + carry/mux tree: each extra input doubles the LUT count.
        per_bit = 2 ** (fanin_bits - LUT_K)
        # depth grows ~ (n-6) mux levels on top of the base LUT (muxes are
        # fast; count them as half a level).
        depth = 1 + math.ceil((fanin_bits - LUT_K) / 2)
    return MapReport(per_bit * out_bits, depth, 0)
