"""Pass 1 — structural netlist lint over the AIG and the mapped LUT net.

Every invariant here is one the constructors in ``repro_torch.synth`` are
supposed to maintain; the lint re-derives them from the raw structure so
a corrupted or hand-edited netlist (or a future transform with a bug)
is caught before it executes. Errors are violations that change or
undefine the computed function (cycles, fanin overflow, undefined
wires, INIT wider than the leaf count); warnings are redundancies a
correct-but-wasteful transform leaves behind (duplicate LUTs, vacuous
leaves, dangling logic).
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.synth.aig import AIG, NONE, lit_var
from repro_torch.synth.lutmap import MappedNetwork

from .report import CheckReport

PASS = "lint"


def lint_aig(aig: AIG, name: str = "aig") -> CheckReport:
    """Structural invariants of the And-Inverter Graph encoding."""
    rep = CheckReport(name)
    n = aig.n_nodes
    if aig.n_pis < 0 or aig.n_pis >= n:
        rep.error(PASS, "pi-range",
                  f"n_pis {aig.n_pis} outside [0, {n})")
        return rep
    # constant node + PI region must be fanin-free
    for node in range(aig.n_pis + 1):
        f0, f1 = aig._f0[node], aig._f1[node]
        rep.checked += 1
        if f0 != NONE or f1 != NONE:
            rep.error(PASS, "pi-fanin",
                      f"node {node} (const/PI) has fanins ({f0}, {f1})",
                      where=f"node {node}")
        if aig._level[node] != 0:
            rep.error(PASS, "level", f"const/PI node {node} at level "
                      f"{aig._level[node]} != 0", where=f"node {node}")
    # AND region: acyclicity (fanins strictly below), canonical operand
    # order, folded constants, strash uniqueness, consistent levels
    seen_pairs: Dict[Tuple[int, int], int] = {}
    for node in range(aig.n_pis + 1, n):
        f0, f1 = aig._f0[node], aig._f1[node]
        rep.checked += 1
        v0, v1 = lit_var(f0), lit_var(f1)
        if f0 < 0 or f1 < 0 or v0 >= n or v1 >= n:
            rep.error(PASS, "bad-fanin",
                      f"node {node} has out-of-range fanins ({f0}, {f1})",
                      where=f"node {node}")
            continue
        if v0 >= node or v1 >= node:
            rep.error(PASS, "cycle",
                      f"node {node} reads node {max(v0, v1)} — fanins must "
                      f"be strictly earlier (acyclic topological ids)",
                      where=f"node {node}")
            continue
        if v0 == 0 or v1 == 0:
            rep.error(PASS, "const-fanin",
                      f"node {node} has an un-propagated constant fanin "
                      f"(literal {f0 if v0 == 0 else f1})",
                      where=f"node {node}")
        if v0 == v1:
            rep.error(PASS, "trivial-and",
                      f"node {node} ANDs literal {f0} with {f1} over the "
                      f"same variable (folds to a constant or a copy)",
                      where=f"node {node}")
        if f0 > f1:
            rep.error(PASS, "operand-order",
                      f"node {node} fanins ({f0}, {f1}) not canonically "
                      f"sorted — strash keys are ambiguous",
                      where=f"node {node}")
        key = (min(f0, f1), max(f0, f1))
        if key in seen_pairs:
            rep.error(PASS, "duplicate-and",
                      f"nodes {seen_pairs[key]} and {node} implement the "
                      f"same AND{key} (structural-hash violation)",
                      where=f"node {node}")
        else:
            seen_pairs[key] = node
        want = 1 + max(aig._level[v0], aig._level[v1])
        if aig._level[node] != want:
            rep.error(PASS, "level",
                      f"node {node} at level {aig._level[node]}, fanin "
                      f"levels imply {want}", where=f"node {node}")
    # outputs must reference real nodes
    for i, o in enumerate(aig.outputs):
        rep.checked += 1
        if o < 0 or lit_var(o) >= n:
            rep.error(PASS, "bad-output",
                      f"output {i} literal {o} references node "
                      f"{lit_var(o)} outside [0, {n})",
                      where=f"output {i}")
    # dead logic: reachable set vs node count (a compact() away — wasteful
    # but function-preserving, so a warning)
    reachable = set(aig.topo_from(
        [o for o in aig.outputs if 0 <= lit_var(o) < n]))
    dead = aig.n_ands - len(reachable)
    rep.checked += 1
    if dead > 0:
        rep.warn(PASS, "dangling-node",
                 f"{dead} AND node(s) unreachable from any output "
                 f"(compact() would remove them)")
    rep.info["n_nodes"] = n
    rep.info["n_dead"] = dead
    return rep


def _tt_depends_on(tt: int, var: int, m: int) -> bool:
    """Does an m-variable truth table depend on variable ``var``?"""
    blk = 1 << var
    mask = 0
    for r in range(1 << m):
        if not (r >> var) & 1:
            mask |= 1 << r
    lo = tt & mask
    hi = (tt >> blk) & mask
    return lo != hi


def lint_mapped(mapped: MappedNetwork, name: str = "mapped") -> CheckReport:
    """Structural invariants of a k-LUT cover."""
    rep = CheckReport(name)
    k = mapped.k
    defined = {0: -1}                       # wire -> defining LUT index
    for p in range(1, mapped.n_pis + 1):
        defined[p] = -1
    seen_fn: Dict[Tuple[Tuple[int, ...], int], int] = {}
    for i, l in enumerate(mapped.luts):
        rep.checked += 1
        m = len(l.leaves)
        where = f"lut {i} (root {l.root})"
        if m > k:
            rep.error(PASS, "fanin-width",
                      f"LUT {i} has {m} leaves > k={k}", where=where)
            continue
        if l.root in defined:
            rep.error(PASS, "duplicate-root",
                      f"wire {l.root} defined twice (earlier LUT "
                      f"{defined[l.root]})", where=where)
        if l.root <= mapped.n_pis:
            rep.error(PASS, "root-range",
                      f"LUT root {l.root} collides with the const/PI "
                      f"wire range [0, {mapped.n_pis}]", where=where)
        for x in l.leaves:
            if x not in defined:
                rep.error(PASS, "undefined-leaf",
                          f"LUT {i} reads wire {x} before (or without) "
                          f"its definition — topological order broken",
                          where=where)
        if len(set(l.leaves)) != m:
            rep.warn(PASS, "repeated-leaf",
                     f"LUT {i} lists a leaf twice {l.leaves}", where=where)
        if not 0 <= l.tt < (1 << (1 << m)):
            rep.error(PASS, "init-width",
                      f"INIT vector needs {l.tt.bit_length()} bits but "
                      f"{m} leaves give only 2^{m}={1 << m}", where=where)
        else:
            if m > 0 and l.tt in (0, (1 << (1 << m)) - 1):
                rep.warn(PASS, "constant-lut",
                         f"LUT {i} computes constant "
                         f"{0 if l.tt == 0 else 1} — constant not "
                         f"propagated", where=where)
            for j in range(m):
                if not _tt_depends_on(l.tt, j, m):
                    rep.warn(PASS, "vacuous-leaf",
                             f"LUT {i} INIT does not depend on leaf "
                             f"{j} (wire {l.leaves[j]})", where=where)
        key = (l.leaves, l.tt)
        if key in seen_fn:
            rep.warn(PASS, "duplicate-lut",
                     f"LUT {i} recomputes LUT {seen_fn[key]} "
                     f"(same leaves and INIT)", where=where)
        else:
            seen_fn[key] = i
        defined.setdefault(l.root, i)
    for i, o in enumerate(mapped.outputs):
        rep.checked += 1
        if lit_var(o) not in defined:
            rep.error(PASS, "undefined-output",
                      f"output {i} reads undefined wire {lit_var(o)}",
                      where=f"output {i}")
    # reachability: LUTs no output cone uses (function-preserving waste)
    live = {lit_var(o) for o in mapped.outputs}
    for l in reversed(mapped.luts):
        if l.root in live:
            live.update(l.leaves)
    dead = sum(1 for l in mapped.luts if l.root not in live)
    rep.checked += 1
    if dead:
        rep.warn(PASS, "dangling-lut",
                 f"{dead} LUT(s) unreachable from any output")
    rep.info["n_luts"] = mapped.n_luts
    rep.info["n_dead_luts"] = dead
    return rep
