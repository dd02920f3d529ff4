"""SAT sweeping over the mapped netlist: find and merge duplicate LUTs.

Technology mapping covers each output cone independently, so two LUTs
can compute the same function (possibly complemented) of the same
support — wasted area the analytic cost model never sees.  This pass
finds them the fraig way: candidate pairs from simulation signatures,
confirmed by SAT (a merge happens only on an UNSAT miter, so it is a
proof, never a heuristic), reported as lint warnings, and optionally
merged — consumers are rewired onto the surviving root (a complemented
merge flips the consumer's truth-table variable), dead LUTs dropped.
Measured LUT savings feed the Table-1 report.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.synth.aig import lit_var
from repro_torch.synth.lutmap import MappedLUT, MappedNetwork

from ..report import CheckReport
from .engine import DEFAULT_CONFLICT_BUDGET, UNet, _Engine, _flip_var

PASS = "formal"

# (keep_lut_index, duplicate_lut_index, complemented)
DupPair = Tuple[int, int, bool]


def find_duplicate_lut_outputs(mapped: MappedNetwork,
                               conflict_budget: int = DEFAULT_CONFLICT_BUDGET,
                               seed: int = 0
                               ) -> Tuple[List[DupPair], Dict[str, int]]:
    """SAT-proven pairs of LUTs whose outputs are equal (or complements).

    Only pairs both of whose proofs fit the conflict budget are
    returned — an unproven candidate is simply not reported, so the
    result is always sound.
    """
    unet = UNet(mapped.n_pis)
    nm = {0: 0}
    for p in range(1, mapped.n_pis + 1):
        nm[p] = 2 * p
    root_lits: List[int] = []
    for l in mapped.luts:
        out = unet.add(tuple(nm[leaf] for leaf in l.leaves), l.tt)
        nm[l.root] = out
        root_lits.append(out)
    eng = _Engine(unet, None, conflict_budget, seed)
    eng.sweep()
    classes: Dict[int, Tuple[int, int]] = {}
    pairs: List[DupPair] = []
    for i, out in enumerate(root_lits):
        r = eng.rep.find_lit(out)
        prev = classes.get(r >> 1)
        if prev is None:
            classes[r >> 1] = (i, r & 1)
        else:
            keep, keep_sign = prev
            pairs.append((keep, i, bool((r & 1) ^ keep_sign)))
    return pairs, eng.stats


def merge_duplicate_lut_outputs(mapped: MappedNetwork,
                                pairs: List[DupPair]) -> MappedNetwork:
    """Rewire consumers of each duplicate onto the kept LUT and drop
    dead LUTs.  The result computes the same outputs (each merge was
    SAT-proven), usually with fewer LUTs."""
    if not pairs:
        return mapped
    # dup root node -> (keep root node, complemented)
    redirect = {mapped.luts[dup].root: (mapped.luts[keep].root, neg)
                for keep, dup, neg in pairs}
    luts: List[MappedLUT] = []
    for l in mapped.luts:
        if l.root in redirect:
            continue
        leaves = list(l.leaves)
        tt = l.tt
        for j, leaf in enumerate(leaves):
            tgt = redirect.get(leaf)
            if tgt is not None:
                leaves[j] = tgt[0]
                if tgt[1]:
                    tt = _flip_var(tt, len(leaves), j)
        luts.append(MappedLUT(l.root, tuple(leaves), tt))
    outputs = []
    for o in mapped.outputs:
        tgt = redirect.get(lit_var(o))
        if tgt is None:
            outputs.append(o)
        else:
            outputs.append(2 * tgt[0] | ((o & 1) ^ int(tgt[1])))
    # drop LUTs no longer reachable from the outputs
    needed = set()
    stack = [lit_var(o) for o in outputs]
    by_root = {l.root: l for l in luts}
    while stack:
        n = stack.pop()
        if n in needed or n not in by_root:
            continue
        needed.add(n)
        stack.extend(by_root[n].leaves)
    luts = [l for l in luts if l.root in needed]
    return MappedNetwork(mapped.n_pis, mapped.k, luts, outputs)


def check_duplicate_lut_outputs(mapped: MappedNetwork,
                                conflict_budget: int
                                = DEFAULT_CONFLICT_BUDGET,
                                seed: int = 0,
                                name: str = "sat-sweep") -> CheckReport:
    """Lint: warn on every SAT-proven duplicate LUT output and record
    the measured LUT count a merge would reach."""
    rep = CheckReport(name)
    pairs, stats = find_duplicate_lut_outputs(
        mapped, conflict_budget=conflict_budget, seed=seed)
    rep.checked += mapped.n_luts
    merged = merge_duplicate_lut_outputs(mapped, pairs)
    rep.info["sat_sweep"] = {
        "dup_lut_outputs": len(pairs),
        "luts": mapped.n_luts,
        "luts_after_sweep": merged.n_luts,
        "sat_queries": stats["queries"],
        "conflicts": stats["conflicts"],
    }
    for keep, dup, neg in pairs:
        k, d = mapped.luts[keep], mapped.luts[dup]
        rep.warn(PASS, "sat-sweep",
                 f"LUT {dup} (root {d.root}) duplicates LUT {keep} "
                 f"(root {k.root}){' complemented' if neg else ''} — "
                 f"SAT-proven; merging would drop "
                 f"{mapped.n_luts - merged.n_luts} LUT(s)")
    return rep
