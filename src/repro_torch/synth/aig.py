"""And-Inverter Graph IR — the multi-level logic representation.

NullaNet Tiny hands espresso'd SOPs to Vivado for multi-level
minimization and technology mapping; ``repro.synth`` replaces that step
offline. The AIG is the standard structural IR of that tool family
(ABC's ``aig``): every node is a 2-input AND, inversion is a literal
attribute on edges, and three invariants are maintained on construction:

  * structural hashing — an ``(a, b)`` AND is created at most once;
  * constant propagation — ANDs with 0/1/x/~x operands fold away;
  * operand canonicalisation — fanins sorted so hash keys are unique.

Encoding: node ids are dense ints, node 0 is constant-FALSE, nodes
``1..n_pis`` are primary inputs, the rest are ANDs. A *literal* is
``2 * node + complement`` (so literal 0 = const0, literal 1 = const1),
matching the AIGER convention.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

NONE = -1


def lit(node: int, compl: int = 0) -> int:
    return (node << 1) | compl


def lit_not(l: int) -> int:
    return l ^ 1

def lit_var(l: int) -> int:
    return l >> 1


def lit_compl(l: int) -> int:
    return l & 1


CONST0 = lit(0, 0)
CONST1 = lit(0, 1)


class AIG:
    """Mutable AIG builder with structural hashing."""

    def __init__(self, n_pis: int = 0):
        self._f0: List[int] = [NONE]      # fanin-0 literal per node
        self._f1: List[int] = [NONE]      # fanin-1 literal per node
        self._level: List[int] = [0]      # logic depth per node
        self._strash: Dict[Tuple[int, int], int] = {}
        self.n_pis = 0
        self.outputs: List[int] = []      # output literals
        for _ in range(n_pis):
            self.add_pi()

    # -- structure ----------------------------------------------------------

    @property
    def n_nodes(self) -> int:
        return len(self._f0)

    @property
    def n_ands(self) -> int:
        return self.n_nodes - 1 - self.n_pis

    def is_pi(self, node: int) -> bool:
        return 1 <= node <= self.n_pis

    def is_and(self, node: int) -> bool:
        return node > self.n_pis

    def fanins(self, node: int) -> Tuple[int, int]:
        return self._f0[node], self._f1[node]

    def level(self, node: int) -> int:
        return self._level[node]

    def depth(self) -> int:
        return max((self._level[lit_var(o)] for o in self.outputs), default=0)

    def add_pi(self) -> int:
        """Append a primary input; returns its (positive) literal."""
        assert self.n_ands == 0, "PIs must be added before any AND node"
        self._f0.append(NONE)
        self._f1.append(NONE)
        self._level.append(0)
        self.n_pis += 1
        return lit(self.n_nodes - 1)

    # -- construction (hashing + constant propagation) ----------------------

    def and2(self, a: int, b: int) -> int:
        if a > b:
            a, b = b, a
        if a == CONST0:
            return CONST0
        if a == CONST1:
            return b
        if a == b:
            return a
        if a == lit_not(b):
            return CONST0
        node = self._strash.get((a, b))
        if node is None:
            node = self.n_nodes
            self._f0.append(a)
            self._f1.append(b)
            self._level.append(
                1 + max(self._level[lit_var(a)], self._level[lit_var(b)]))
            self._strash[(a, b)] = node
        return lit(node)

    def or2(self, a: int, b: int) -> int:
        return lit_not(self.and2(lit_not(a), lit_not(b)))

    def xor2(self, a: int, b: int) -> int:
        return self.or2(self.and2(a, lit_not(b)), self.and2(lit_not(a), b))

    def mux(self, sel: int, t: int, e: int) -> int:
        return self.or2(self.and2(sel, t), self.and2(lit_not(sel), e))

    def _reduce(self, lits: Sequence[int], op, identity: int) -> int:
        """Level-aware (Huffman) reduction: combine the two shallowest
        operands first, which yields a depth-minimal tree even for skewed
        operand levels."""
        if not lits:
            return identity
        import heapq
        heap = [(self._level[lit_var(l)], i, l) for i, l in enumerate(lits)]
        heapq.heapify(heap)
        tie = len(lits)
        while len(heap) > 1:
            _, _, x = heapq.heappop(heap)
            _, _, y = heapq.heappop(heap)
            z = op(x, y)
            heapq.heappush(heap, (self._level[lit_var(z)], tie, z))
            tie += 1
        return heap[0][2]

    def and_many(self, lits: Sequence[int]) -> int:
        return self._reduce(lits, self.and2, CONST1)

    def or_many(self, lits: Sequence[int]) -> int:
        return self._reduce(lits, self.or2, CONST0)

    # -- traversal ----------------------------------------------------------

    def topo_from(self, roots: Iterable[int]) -> List[int]:
        """AND node ids reachable from root literals, in topological order
        (fanins first). Iterative DFS — logic depth can exceed Python's
        recursion limit on wide networks."""
        seen = set()
        order: List[int] = []
        for r in roots:
            n = lit_var(r)
            if n in seen or not self.is_and(n):
                continue
            stack = [(n, False)]
            while stack:
                node, expanded = stack.pop()
                if expanded:
                    order.append(node)
                    continue
                if node in seen or not self.is_and(node):
                    continue
                seen.add(node)
                stack.append((node, True))
                f0, f1 = self._f0[node], self._f1[node]
                stack.append((lit_var(f1), False))
                stack.append((lit_var(f0), False))
        return order

    def fanin_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(f0, f1) int32 fanin-literal arrays over the AND nodes, in node
        order — the linear program consumed by the simulators."""
        first = self.n_pis + 1
        return (np.asarray(self._f0[first:], np.int32),
                np.asarray(self._f1[first:], np.int32))

    def fanout_counts(self) -> np.ndarray:
        """Structural fanout per node (outputs count as one fanout each)."""
        cnt = np.zeros(self.n_nodes, np.int64)
        for n in range(self.n_pis + 1, self.n_nodes):
            cnt[lit_var(self._f0[n])] += 1
            cnt[lit_var(self._f1[n])] += 1
        for o in self.outputs:
            cnt[lit_var(o)] += 1
        return cnt

    def compact(self) -> "AIG":
        """Rebuild keeping only logic reachable from the outputs. PIs keep
        their count and order; dead ANDs (e.g. rewriting garbage) vanish."""
        new = AIG(self.n_pis)
        old2new = {0: CONST0}
        for p in range(1, self.n_pis + 1):
            old2new[p] = lit(p)

        def map_lit(l: int) -> int:
            return old2new[lit_var(l)] ^ lit_compl(l)

        for n in self.topo_from(self.outputs):
            old2new[n] = new.and2(map_lit(self._f0[n]), map_lit(self._f1[n]))
        new.outputs = [map_lit(o) for o in self.outputs]
        return new

    # -- local function extraction ------------------------------------------

    def cut_tt(self, root: int, leaves: Sequence[int]) -> int:
        """Truth table (python int, bit r = value on minterm r) of the cone
        between ``leaves`` (node ids, var order = list order) and the
        ``root`` node id. Every path from root must hit a leaf or a
        constant; asserts otherwise."""
        m = len(leaves)
        assert m <= 16
        mask = (1 << (1 << m)) - 1
        tts: Dict[int, int] = {0: 0}
        for i, leaf in enumerate(leaves):
            tts[leaf] = _var_tt(i, m)
        if root in tts:
            return tts[root]
        stack = [(root, False)]
        while stack:
            node, expanded = stack.pop()
            if node in tts:
                continue
            assert self.is_and(node), \
                f"node {node} not in the cut cone of {leaves}"
            f0, f1 = self._f0[node], self._f1[node]
            if expanded:
                t0 = tts[lit_var(f0)] ^ (mask if lit_compl(f0) else 0)
                t1 = tts[lit_var(f1)] ^ (mask if lit_compl(f1) else 0)
                tts[node] = t0 & t1
                continue
            stack.append((node, True))
            if lit_var(f0) not in tts:
                stack.append((lit_var(f0), False))
            if lit_var(f1) not in tts:
                stack.append((lit_var(f1), False))
        return tts[root]


_VAR_TT_CACHE: Dict[Tuple[int, int], int] = {}


def _var_tt(i: int, m: int) -> int:
    """Truth table of variable i among m variables."""
    key = (i, m)
    tt = _VAR_TT_CACHE.get(key)
    if tt is None:
        tt = 0
        for r in range(1 << m):
            if (r >> i) & 1:
                tt |= 1 << r
        _VAR_TT_CACHE[key] = tt
    return tt


def tt_expand(tt: int, m: int, k: int) -> int:
    """Pad an m-variable truth table to k variables (new vars ignored)."""
    for _ in range(k - m):
        tt |= tt << (1 << m)
        m += 1
    return tt
