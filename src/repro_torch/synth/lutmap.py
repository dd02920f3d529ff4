"""Technology mapping: depth-optimal k-feasible-cut covering into k-LUTs.

FlowMap-style flow on the priority-cut sets from ``cuts.py``:

  1. *Depth pass* — arrival times computed during cut enumeration give
     each node its depth-optimal cut (exact for the cuts kept; the
     priority scheme keeps the best-depth cut per node by construction).
  2. *Area recovery* — with the network depth fixed as the required time
     at the outputs, repeated passes re-select, for every node, the
     min-area-flow cut that still meets the node's required time, then
     re-extract the cover. Nodes off the critical path trade depth slack
     for LUT sharing — the classic area-flow recovery loop.
  3. *Cover extraction* — walk from the outputs through chosen cuts;
     every visited node becomes one LUT whose truth table is the cut
     function (computed exactly from the AIG cone).

The result is a ``MappedNetwork``: the measured LUT count / depth that
``core.lutmap``'s analytic model only estimates, and the executable form
behind the bitplane inference path and the Verilog emitter.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.lutcost import LUT_K, MapReport

from .aig import AIG, lit_var
from .cuts import Cut, enumerate_cuts


@dataclasses.dataclass(frozen=True)
class MappedLUT:
    root: int                   # AIG node id this LUT implements
    leaves: Tuple[int, ...]     # AIG node ids (PIs or other LUT roots)
    tt: int                     # 2^len(leaves)-bit truth table (python int)


@dataclasses.dataclass
class MappedNetwork:
    """A k-LUT cover of an AIG. ``outputs`` are AIG literals whose vars
    are PIs, LUT roots, or the constant node 0."""

    n_pis: int
    k: int
    luts: List[MappedLUT]       # topological order (leaves before roots)
    outputs: List[int]

    @property
    def n_luts(self) -> int:
        return len(self.luts)

    def levels(self) -> Dict[int, int]:
        """LUT level per root node id (PIs/const are level 0)."""
        lvl: Dict[int, int] = {0: 0}
        for p in range(1, self.n_pis + 1):
            lvl[p] = 0
        for l in self.luts:
            lvl[l.root] = 1 + max((lvl[x] for x in l.leaves), default=0)
        return lvl

    @property
    def depth(self) -> int:
        lvl = self.levels()
        return max((lvl[lit_var(o)] for o in self.outputs), default=0)

    def report(self, ffs: int = 0) -> MapReport:
        """Measured LUTs/depth as a ``core.lutcost.MapReport`` so the
        structural numbers aggregate with the analytic cost model."""
        return MapReport(self.n_luts, self.depth, ffs)


def _extract_cover(aig: AIG, choice: List[Optional[Cut]],
                   ) -> List[MappedLUT]:
    """Cover = transitive closure of chosen cuts from the outputs down."""
    needed: List[int] = []
    seen = set()
    stack = [lit_var(o) for o in aig.outputs]
    while stack:
        n = stack.pop()
        if n in seen or not aig.is_and(n):
            continue
        seen.add(n)
        needed.append(n)
        stack.extend(choice[n].leaves)
    luts = []
    for n in sorted(needed):        # node ids ascend topologically
        cut = choice[n]
        luts.append(MappedLUT(n, cut.leaves, aig.cut_tt(n, cut.leaves)))
    return luts


def map_aig(aig: AIG, k: int = LUT_K, n_cuts: int = 8,
            area_passes: int = 2) -> MappedNetwork:
    cuts, arrival, _ = enumerate_cuts(aig, k=k, n_cuts=n_cuts)
    n = aig.n_nodes

    # ---- 1. depth-optimal choice (best cut is sorted first; skip the
    # trivial self-cut appended at the end of each list) ----
    def real_cuts(node: int) -> List[Cut]:
        return [c for c in cuts[node] if c.leaves != (node,)]

    choice: List[Optional[Cut]] = [None] * n
    for node in range(aig.n_pis + 1, n):
        choice[node] = real_cuts(node)[0]

    luts = _extract_cover(aig, choice)

    # ---- 2. area recovery under required times ----
    req_total = max((arrival[lit_var(o)] for o in aig.outputs), default=0)
    for _ in range(area_passes):
        # required times over the current cover
        req = [None] * n
        for o in aig.outputs:
            v = lit_var(o)
            req[v] = req_total
        for l in reversed(luts):
            r = req[l.root]
            if r is None:
                continue
            for x in l.leaves:
                rx = r - 1
                if req[x] is None or rx < req[x]:
                    req[x] = rx
        # cover references (how many chosen LUTs read each node)
        refs = [0] * n
        for l in luts:
            for x in l.leaves:
                refs[x] += 1
        for o in aig.outputs:
            refs[lit_var(o)] += 1
        # re-select: min-area cut meeting the required time, where leaf
        # arrivals are recomputed under the *new* selection (ascending ids
        # = topological order, so leaves are final when a node is visited).
        # Area score discounts leaves already referenced by the cover.
        new_choice: List[Optional[Cut]] = [None] * n
        new_arr = [0] * n
        for node in range(aig.n_pis + 1, n):
            limit = req[node] if req[node] is not None else req_total
            best, best_score = None, None
            fallback, fallback_d = None, None
            for c in real_cuts(node):
                d = 1 + max((new_arr[x] for x in c.leaves), default=0)
                if fallback_d is None or d < fallback_d:
                    fallback, fallback_d = c, d
                if d > limit:
                    continue
                score = (sum(1.0 / max(1, refs[x])
                             for x in c.leaves if aig.is_and(x)),
                         c.aflow, len(c.leaves))
                if best_score is None or score < best_score:
                    best, best_score = c, score
            if best is None:        # slack exhausted: take the fastest cut
                best = fallback
            new_choice[node] = best
            new_arr[node] = 1 + max((new_arr[x] for x in best.leaves),
                                    default=0)
        choice = new_choice
        luts = _extract_cover(aig, choice)

    return MappedNetwork(aig.n_pis, k, luts, list(aig.outputs))
