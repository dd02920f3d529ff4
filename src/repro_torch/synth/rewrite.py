"""DAG-aware AIG optimization passes: balancing and cut rewriting.

``balance`` re-associates AND trees for minimum depth (ABC's ``balance``):
each maximal single-fanout conjunction cone is collapsed and rebuilt as
a level-aware Huffman tree, sharing preserved at multi-fanout frontiers.

``rewrite`` is cut-based resynthesis (ABC's ``rewrite`` in spirit): the
network is reconstructed node by node into a fresh structurally-hashed
AIG; for each node every enumerated k-cut's local function is
re-synthesized from its minimized SOP (both phases) *against the new
AIG's hash table*, so logic already built elsewhere in the DAG costs
zero — that sharing is what makes the pass DAG-aware rather than
tree-local. The cheapest implementation (fewest freshly created nodes,
ties broken on depth) wins; rejected candidates become dead nodes that
the final ``compact`` sweeps out. Every replacement is functionally
exact by construction (the cut truth table is the spec), so the passes
preserve equivalence unconditionally.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .aig import AIG, CONST0, lit, lit_compl, lit_not, lit_var
from .cuts import enumerate_cuts


def balance(aig: AIG) -> AIG:
    new = AIG(aig.n_pis)
    fanout = aig.fanout_counts()
    mapped: Dict[int, int] = {0: CONST0}
    for p in range(1, aig.n_pis + 1):
        mapped[p] = lit(p)

    def map_lit(l: int) -> int:
        return mapped[lit_var(l)] ^ lit_compl(l)

    def cone_leaves(root: int) -> List[int]:
        """Literals feeding the maximal conjunction cone rooted at an AND:
        expand through non-complemented, single-fanout AND edges."""
        leaves: List[int] = []
        stack = list(aig.fanins(root))
        while stack:
            l = stack.pop()
            n = lit_var(l)
            if (not lit_compl(l) and aig.is_and(n) and fanout[n] == 1):
                stack.extend(aig.fanins(n))
            else:
                leaves.append(l)
        return leaves

    # multi-fanout / complemented-edge ANDs are the cone roots; absorbed
    # single-fanout internals never get (and never need) an image of
    # their own, so process roots only.
    order = aig.topo_from(aig.outputs)
    root_set = set()
    for n in order:
        for l in aig.fanins(n):
            m = lit_var(l)
            if aig.is_and(m) and (lit_compl(l) or fanout[m] != 1):
                root_set.add(m)
    for o in aig.outputs:
        if aig.is_and(lit_var(o)):
            root_set.add(lit_var(o))
    for n in order:
        if n not in root_set:
            continue
        leaves = [map_lit(l) for l in cone_leaves(n)]
        mapped[n] = new.and_many(leaves)
    new.outputs = [map_lit(o) for o in aig.outputs]
    return new.compact()


def _tt_candidate(new: AIG, tt: int, m: int, leaf_lits: List[int]) -> int:
    """Resynthesize an m-var function from its minimized SOP into ``new``
    (cheaper phase of function/complement); returns the output literal."""
    from .from_sop import cover_to_aig, minimize_both_phases

    n_rows = 1 << m
    onset = np.zeros(n_rows, bool)
    for r in range(n_rows):
        if (tt >> r) & 1:
            onset[r] = True
    cov, inv = minimize_both_phases(onset)
    res = cover_to_aig(new, cov, leaf_lits)
    return lit_not(res) if inv else res


def rewrite(aig: AIG, k: int = 4, n_cuts: int = 6) -> AIG:
    cuts, _, _ = enumerate_cuts(aig, k=k, n_cuts=n_cuts)
    new = AIG(aig.n_pis)
    mapped: Dict[int, int] = {0: CONST0}
    for p in range(1, aig.n_pis + 1):
        mapped[p] = lit(p)

    def map_lit(l: int) -> int:
        return mapped[lit_var(l)] ^ lit_compl(l)

    for node in aig.topo_from(aig.outputs):
        f0, f1 = aig.fanins(node)
        # candidate 0: plain reconstruction (never structurally worse)
        before = new.n_nodes
        best = new.and2(map_lit(f0), map_lit(f1))
        best_cost = new.n_nodes - before
        best_level = new.level(lit_var(best))
        for cut in cuts[node]:
            m = len(cut.leaves)
            if m < 2 or m > k or cut.leaves == (node,):
                continue
            tt = aig.cut_tt(node, cut.leaves)
            leaf_lits = [mapped[x] for x in cut.leaves]
            before = new.n_nodes
            cand = _tt_candidate(new, tt, m, leaf_lits)
            cost = new.n_nodes - before
            lvl = new.level(lit_var(cand))
            if (cost, lvl) < (best_cost, best_level):
                best, best_cost, best_level = cand, cost, lvl
        mapped[node] = best
    new.outputs = [map_lit(o) for o in aig.outputs]
    return new.compact()


def optimize(aig: AIG, rounds: int = 1, rewrite_k: int = 4) -> AIG:
    """The standard script: (balance; rewrite)+ ; balance."""
    for _ in range(rounds):
        aig = balance(aig)
        aig = rewrite(aig, k=rewrite_k)
    return balance(aig)
