"""SAT-based formal equivalence: prove miters instead of sampling them.

The sampled miter in ``check.equiv`` is exhaustive (a proof) up to 20
PIs and a filter beyond.  This engine closes the gap: both sides of a
stage adjacency are imported into one *unified netlist* sharing primary
inputs, and equivalence is proved by SAT sweeping:

  1. **Import.**  AIGs become AND gates, mapped netlists / DevicePlans
     become LUT gates.  Every gate is normalized (complemented fanins
     folded into the truth table, constant / duplicate / vacuous inputs
     removed, inputs sorted, output phase canonicalized) and
     structurally hashed, so identical structure across the two sides
     merges for free.
  2. **Simulate.**  2048 random patterns (care-set-respecting when a
     quantizer care set is given) give every node a signature; nodes
     sharing a signature up to complement are equivalence candidates.
  3. **Sweep.**  Candidates are proved bottom-up with small windowed
     CNF queries (cone capped, frontier nodes become free variables —
     sound, because a merge happens only on UNSAT, i.e. equivalence
     over *all* frontier valuations).  Proven merges rewrite fanins via
     a union-find over literals, shrinking every later query.
  4. **Final miter.**  Output pairs whose literals merged are proved;
     any remainder gets a full-cone miter CNF (with the care set as
     blocking clauses).  ``SAT`` yields a concrete PI counterexample —
     always replayed through the bitplane simulator before reporting —
     ``UNSAT`` a proof, and an exhausted conflict budget ``UNPROVEN``,
     which callers must surface (and back with sampling), never hide.
"""
from __future__ import annotations

import dataclasses
import heapq
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.synth.aig import AIG, lit_var
from repro_torch.synth.simulate import WORD_BITS, pack_bits

from .cnf import (CNF, and_clauses, care_code_clauses, lut_clauses,
                  miter_clauses)
from .solver import Solver

UNSAT = "UNSAT"          # proved equivalent (on the care set)
SAT = "SAT"              # proved *in*equivalent; counterexample attached
UNPROVEN = "UNPROVEN"    # conflict budget exhausted; fall back to sampling

DEFAULT_CONFLICT_BUDGET = 200_000
_QUERY_CONFLICTS = 2_000         # per internal sweep query
_WINDOW_CAP = 1_000              # gates expanded per sweep query
_SIM_WORDS = 64                  # 2048 signature patterns
_AND_TT = 0b1000                 # tt of a 2-input AND over (a, b)

_FULL_WORD = np.uint32(0xFFFFFFFF)


# ---------------------------------------------------------------------------
# truth-table surgery (python ints, row r bit j = input j of minterm r)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _mask0(m: int, j: int) -> int:
    """Rows of an m-var table whose bit j is 0."""
    mask = 0
    for r in range(1 << m):
        if not (r >> j) & 1:
            mask |= 1 << r
    return mask


def _flip_var(tt: int, m: int, j: int) -> int:
    """tt with input j complemented: bit r <- bit (r ^ 2^j)."""
    m0 = _mask0(m, j)
    step = 1 << j
    full = (1 << (1 << m)) - 1
    return (((tt & m0) << step) | ((tt & ~m0 & full) >> step)) & full


def _cofactor(tt: int, m: int, j: int, val: int) -> int:
    """tt with input j fixed to val (result has m-1 inputs)."""
    out = 0
    idx = 0
    for r in range(1 << m):
        if ((r >> j) & 1) == val:
            if (tt >> r) & 1:
                out |= 1 << idx
            idx += 1
    return out


def _tie_vars(tt: int, m: int, i: int, j: int) -> int:
    """tt with input i (> j) forced equal to input j, then removed."""
    out = 0
    for rp in range(1 << (m - 1)):
        low = rp & ((1 << i) - 1)
        high = rp >> i
        bj = (rp >> j) & 1
        r = low | (bj << i) | (high << (i + 1))
        if (tt >> r) & 1:
            out |= 1 << rp
    return out


def _permute_vars(tt: int, m: int, perm: Sequence[int]) -> int:
    """Reindex inputs: new input j reads old input perm[j]."""
    out = 0
    for r in range(1 << m):
        ro = 0
        for jn in range(m):
            if (r >> jn) & 1:
                ro |= 1 << perm[jn]
        if (tt >> ro) & 1:
            out |= 1 << r
    return out


def _normalize(fanins: Sequence[int], tt: int):
    """Canonicalize a LUT gate.

    Returns ``("lit", l)`` when the gate degenerates to a constant or a
    single (possibly complemented) fanin, else ``("gate", fanins, tt,
    compl)`` with positive sorted fanins, no constant/duplicate/vacuous
    inputs, and tt's minterm 0 false (output phase in ``compl``).
    """
    fanins = list(fanins)
    m = len(fanins)
    full = (1 << (1 << m)) - 1
    tt &= full
    # fold fanin complements into the table
    for j, f in enumerate(fanins):
        if f & 1:
            tt = _flip_var(tt, m, j)
            fanins[j] = f ^ 1
    # drop constant inputs (only const-FALSE survives complement fold)
    j = 0
    while j < len(fanins):
        if fanins[j] == 0:
            tt = _cofactor(tt, len(fanins), j, 0)
            fanins.pop(j)
        else:
            j += 1
    # merge duplicate inputs
    i = 1
    while i < len(fanins):
        j = fanins.index(fanins[i])
        if j < i:
            tt = _tie_vars(tt, len(fanins), i, j)
            fanins.pop(i)
        else:
            i += 1
    # drop vacuous inputs
    j = 0
    while j < len(fanins):
        c0 = _cofactor(tt, len(fanins), j, 0)
        if c0 == _cofactor(tt, len(fanins), j, 1):
            tt = c0
            fanins.pop(j)
        else:
            j += 1
    m = len(fanins)
    if m == 0:
        return ("lit", 1 if tt & 1 else 0)
    if m == 1:
        return ("lit", fanins[0] ^ (0 if tt == 0b10 else 1))
    order = sorted(range(m), key=lambda p: fanins[p])
    if order != list(range(m)):
        tt = _permute_vars(tt, m, order)
        fanins = [fanins[p] for p in order]
    compl = tt & 1
    if compl:
        tt = ~tt & ((1 << (1 << m)) - 1)
    return ("gate", tuple(fanins), tt, compl)


def _tt_words(tt: int, m: int) -> np.ndarray:
    nbytes = max(1, ((1 << m) + 7) >> 3)
    raw = np.frombuffer(tt.to_bytes(nbytes, "little"), np.uint8)
    return np.unpackbits(raw, bitorder="little")[: 1 << m].astype(np.uint32)


# ---------------------------------------------------------------------------
# unified netlist
# ---------------------------------------------------------------------------

class UNet:
    """Both miter sides in one gate list over shared PIs.

    Node ids: 0 = const-FALSE, 1..n_pis = PIs, then gates.  Literals
    follow the AIG convention ``2*node | compl``.  Gates are stored
    normalized (see :func:`_normalize`) and structurally hashed.
    """

    def __init__(self, n_pis: int):
        self.n_pis = n_pis
        self.gates: List[Tuple[Tuple[int, ...], int]] = []
        self._strash: Dict[Tuple[Tuple[int, ...], int], int] = {}

    @property
    def n_nodes(self) -> int:
        return self.n_pis + 1 + len(self.gates)

    def is_gate(self, node: int) -> bool:
        return node > self.n_pis

    def gate(self, node: int) -> Tuple[Tuple[int, ...], int]:
        return self.gates[node - self.n_pis - 1]

    def add(self, fanins: Sequence[int], tt: int) -> int:
        norm = _normalize(fanins, tt)
        if norm[0] == "lit":
            return norm[1]
        _, fans, tt, compl = norm
        key = (fans, tt)
        node = self._strash.get(key)
        if node is None:
            node = self.n_nodes
            self.gates.append(key)
            self._strash[key] = node
        return 2 * node | compl

    def and2(self, a: int, b: int) -> int:
        return self.add((a, b), _AND_TT)

    def simulate(self, pi_words: np.ndarray) -> np.ndarray:
        """(n_pis, W) packed words -> (n_nodes, W) node values."""
        w = pi_words.shape[1]
        vals = np.zeros((self.n_nodes, w), np.uint32)
        vals[1: self.n_pis + 1] = pi_words
        for i, (fanins, tt) in enumerate(self.gates):
            ins = [vals[f >> 1] ^ (_FULL_WORD if f & 1 else np.uint32(0))
                   for f in fanins]
            if tt == _AND_TT and len(fanins) == 2:
                vals[self.n_pis + 1 + i] = ins[0] & ins[1]
                continue
            m = len(fanins)
            state = np.where(_tt_words(tt, m)[:, None].astype(bool),
                             _FULL_WORD, np.uint32(0))
            state = np.broadcast_to(state, (1 << m, w))
            half = (1 << m) >> 1
            for j in range(m - 1, -1, -1):
                sel = ins[j]
                state = (state[:half] & ~sel) | (state[half:] & sel)
                half >>= 1
            vals[self.n_pis + 1 + i] = state[0]
        return vals


# ---------------------------------------------------------------------------
# importers
# ---------------------------------------------------------------------------

def import_aig(unet: UNet, aig: AIG) -> List[int]:
    """Add an AIG's AND gates; returns its output literals in unet."""
    assert aig.n_pis == unet.n_pis
    nm = [0] * aig.n_nodes
    for p in range(1, aig.n_pis + 1):
        nm[p] = 2 * p
    for node in range(aig.n_pis + 1, aig.n_nodes):
        if not aig.is_and(node):
            continue
        f0, f1 = aig.fanins(node)
        a = nm[lit_var(f0)] ^ (f0 & 1)
        b = nm[lit_var(f1)] ^ (f1 & 1)
        nm[node] = unet.and2(a, b)
    return [nm[lit_var(o)] ^ (o & 1) for o in aig.outputs]


def import_mapped(unet: UNet, mapped) -> List[int]:
    """Add a mapped k-LUT netlist as LUT gates (per-INIT semantics)."""
    assert mapped.n_pis == unet.n_pis
    nm = {0: 0}
    for p in range(1, mapped.n_pis + 1):
        nm[p] = 2 * p
    for l in mapped.luts:
        ins = tuple(nm[leaf] for leaf in l.leaves)
        nm[l.root] = unet.add(ins, l.tt)
    return [nm[lit_var(o)] ^ (o & 1) for o in mapped.outputs]


def import_plan(unet: UNet, dplan) -> List[int]:
    """Add a DevicePlan slot by slot (pad slots skipped), independent of
    the MappedNetwork it was compiled from."""
    assert dplan.n_pis == unet.n_pis
    wm = {0: 0}
    for p in range(1, dplan.n_pis + 1):
        wm[p] = 2 * p
    n_levels, lw, _k = dplan.leaf_idx.shape
    for lvl in range(n_levels):
        for s in range(lw):
            ow = int(dplan.out_wires[lvl, s])
            if ow >= dplan.n_wires:          # pad slot writes the dump row
                continue
            ins = tuple(wm[int(wi)] for wi in dplan.leaf_idx[lvl, s])
            tt = 0
            for r, bit in enumerate(dplan.tt_bits[lvl, s]):
                if bit:
                    tt |= 1 << r
            wm[ow] = unet.add(ins, tt)
    return [wm[int(i)] ^ (1 if neg else 0)
            for i, neg in zip(dplan.out_idx, dplan.out_neg)]


# ---------------------------------------------------------------------------
# care set
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CareSet:
    """Reachable-code constraint: each group is (0-based PI indices of
    one little-endian code, number of valid codes)."""

    groups: Tuple[Tuple[Tuple[int, ...], int], ...]

    @staticmethod
    def from_network(net) -> "CareSet":
        bits = net.in_spec.code_bits
        n_valid = net.in_spec.n_levels
        return CareSet(tuple(
            (tuple(range(i * bits, (i + 1) * bits)), n_valid)
            for i in range(net.n_inputs)))

    def random_words(self, n_pis: int, n_words: int,
                     rng: np.random.Generator) -> np.ndarray:
        """Random packed PI words drawing every group from its valid
        codes (free PIs uniform)."""
        lanes = n_words * WORD_BITS
        planes = rng.integers(0, 2, (n_pis, lanes), dtype=np.uint8)
        for pis, n_valid in self.groups:
            codes = rng.integers(0, n_valid, lanes)
            for b, p in enumerate(pis):
                planes[p] = (codes >> b) & 1
        return pack_bits(planes)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

class _Repr:
    """Union-find over literals: rep[node] is the literal the node was
    proved equal to (its var is always a smaller node id)."""

    def __init__(self, n_nodes: int):
        self.rep = [2 * n for n in range(n_nodes)]

    def find(self, node: int) -> int:
        l = self.rep[node]
        if l >> 1 == node:
            return l
        r = self.find(l >> 1) ^ (l & 1)
        self.rep[node] = r
        return r

    def find_lit(self, lit: int) -> int:
        return self.find(lit >> 1) ^ (lit & 1)


@dataclasses.dataclass
class FormalResult:
    """Outcome of a formal equivalence query.

    ``verdict``: ``UNSAT`` (proved equivalent on the care set), ``SAT``
    (inequivalent; ``cex`` holds the PI bit vector, already replayed on
    the unified netlist), or ``UNPROVEN`` (budget exhausted — the
    caller must fall back to sampling and say so).
    """

    verdict: str
    stats: Dict[str, int]
    cex: Optional[Tuple[int, ...]] = None

    @property
    def proved(self) -> bool:
        return self.verdict == UNSAT


class _Engine:
    def __init__(self, unet: UNet, care: Optional[CareSet],
                 budget: int, seed: int):
        self.unet = unet
        self.care = care
        self.budget = budget
        self.seed = seed
        self.rep = _Repr(unet.n_nodes)
        self.stats: Dict[str, int] = {
            "nodes": unet.n_nodes, "queries": 0, "merged_struct": 0,
            "merged_sat": 0, "refuted": 0, "query_unknown": 0,
            "conflicts": 0, "decisions": 0, "propagations": 0,
            "restarts": 0, "learned": 0,
        }

    def _remaining(self) -> int:
        return self.budget - self.stats["conflicts"]

    def _absorb(self, solver: Solver) -> None:
        for k in ("conflicts", "decisions", "propagations", "restarts",
                  "learned"):
            self.stats[k] += solver.stats[k]

    # ----------------------------------------------------- CNF windows
    def _collect(self, roots: Sequence[int], cap: int):
        """Expand cones (through reprs) from ``roots`` in descending
        node-id order; returns (expanded gates, frontier nodes)."""
        unet, rep = self.unet, self.rep
        heap = []
        seen = set()
        for n in roots:
            if n not in seen:
                seen.add(n)
                heapq.heappush(heap, -n)
        expanded, frontier = set(), set()
        while heap:
            node = -heapq.heappop(heap)
            if not unet.is_gate(node) or len(expanded) >= cap:
                frontier.add(node)
                continue
            expanded.add(node)
            for f in unet.gate(node)[0]:
                v = rep.find_lit(f) >> 1
                if v not in seen:
                    seen.add(v)
                    heapq.heappush(heap, -v)
        return expanded, frontier

    def _build_cnf(self, roots: Sequence[int], cap: int,
                   extra_lits: Sequence[int] = ()):
        """CNF over the window: clauses for expanded gates (fanins
        mapped through reprs), frontier nodes free, care clauses for
        touched PI groups.  ``extra_lits`` (e.g. the miter literals the
        caller will constrain) are allocated *before* the const/care
        clauses so a bare-const or bare-PI miter leg still gets its
        FALSE unit / care constraint.  Returns (cnf, var_of node->var,
        vlit)."""
        expanded, _ = self._collect(roots, cap)
        cnf = CNF()
        var_of: Dict[int, int] = {}

        def vlit(net_lit: int) -> int:
            v = net_lit >> 1
            var = var_of.get(v)
            if var is None:
                var = var_of[v] = cnf.new_var()
            return 2 * var | (net_lit & 1)

        for node in sorted(expanded):
            fanins, tt = self.unet.gate(node)
            ins = [vlit(self.rep.find_lit(f)) for f in fanins]
            out = vlit(2 * node)
            if tt == _AND_TT and len(ins) == 2:
                and_clauses(cnf, out, ins[0], ins[1])
            else:
                lut_clauses(cnf, out, ins, tt)
        for l in extra_lits:
            vlit(l)
        if 0 in var_of:
            cnf.add(2 * var_of[0] ^ 1)      # const node is FALSE
        if self.care is not None:
            for pis, n_valid in self.care.groups:
                if any((p + 1) in var_of for p in pis):
                    care_code_clauses(cnf, [vlit(2 * (p + 1)) for p in pis],
                                      n_valid)
        return cnf, var_of, vlit

    def _query_equal(self, lit_a: int, lit_b: int, conflicts: int):
        """SAT query: can lit_a != lit_b?  Returns solver verdict."""
        self.stats["queries"] += 1
        roots = [l >> 1 for l in (lit_a, lit_b) if (l >> 1) != 0]
        cnf, _, vlit = self._build_cnf(roots, _WINDOW_CAP,
                                       extra_lits=(lit_a, lit_b))
        miter_clauses(cnf, [(vlit(lit_a), vlit(lit_b))])
        s = cnf.solver()
        verdict = s.solve(conflict_budget=conflicts)
        self._absorb(s)
        return verdict

    # ------------------------------------------------------- sweeping
    def sweep(self, sim_words: int = _SIM_WORDS) -> None:
        unet, rep = self.unet, self.rep
        rng = np.random.default_rng(self.seed)
        if self.care is not None:
            pi_words = self.care.random_words(unet.n_pis, sim_words, rng)
        else:
            pi_words = rng.integers(0, 1 << WORD_BITS,
                                    (unet.n_pis, sim_words), dtype=np.uint32)
        vals = unet.simulate(pi_words)
        inv = ~vals
        sig_class: Dict[bytes, Tuple[int, int]] = {}
        strash: Dict[Tuple[Tuple[int, ...], int], Tuple[int, int]] = {}
        for node in range(unet.n_nodes):
            s0, s1 = vals[node].tobytes(), inv[node].tobytes()
            flip = s1 < s0
            canon = s1 if flip else s0
            if not unet.is_gate(node):
                sig_class.setdefault(canon, (node, flip))
                continue
            # structural rehash through current reprs
            fanins, tt = unet.gate(node)
            norm = _normalize([rep.find_lit(f) for f in fanins], tt)
            if norm[0] == "lit":
                rep.rep[node] = rep.find_lit(norm[1])
                self.stats["merged_struct"] += 1
                continue
            _, fans, ntt, compl = norm
            prev = strash.get((fans, ntt))
            if prev is not None and prev[0] != node:
                # node = f^compl, prev_node = f^prev_compl for the same
                # phase-canonical f => node = prev_node ^ (compl ^ pc)
                rep.rep[node] = rep.find(prev[0]) ^ (compl ^ prev[1])
                self.stats["merged_struct"] += 1
                continue
            strash.setdefault((fans, ntt), (node, compl))
            # signature candidate
            hit = sig_class.get(canon)
            if hit is None:
                sig_class[canon] = (node, flip)
                continue
            cand, cflip = hit
            target = rep.find(cand) ^ (flip ^ cflip)
            if target == rep.find(node):
                continue
            if self._remaining() <= 0:
                self.stats["query_unknown"] += 1
                continue
            cap = min(_QUERY_CONFLICTS, self._remaining())
            verdict = self._query_equal(2 * node, target, cap)
            if verdict == "UNSAT":
                rep.rep[node] = target
                self.stats["merged_sat"] += 1
            elif verdict == "SAT":
                self.stats["refuted"] += 1
            else:
                self.stats["query_unknown"] += 1

    # ---------------------------------------------------- final miter
    def prove(self, pairs: Sequence[Tuple[int, int]],
              sim_words: int = _SIM_WORDS) -> FormalResult:
        self.sweep(sim_words=sim_words)
        rep = self.rep
        unresolved = [(a, b) for a, b in pairs
                      if rep.find_lit(a) != rep.find_lit(b)]
        self.stats["outputs"] = len(pairs)
        self.stats["outputs_merged"] = len(pairs) - len(unresolved)
        if not unresolved:
            return FormalResult(UNSAT, self.stats)
        remaining = self._remaining()
        if remaining <= 0:
            return FormalResult(UNPROVEN, self.stats)
        miter_lits = [rep.find_lit(l) for ab in unresolved for l in ab]
        cnf, var_of, vlit = self._build_cnf(
            [l >> 1 for l in miter_lits if (l >> 1) != 0],
            cap=self.unet.n_nodes + 1, extra_lits=miter_lits)
        miter_clauses(cnf, [(vlit(rep.find_lit(a)), vlit(rep.find_lit(b)))
                            for a, b in unresolved])
        s = cnf.solver()
        verdict = s.solve(conflict_budget=remaining)
        self._absorb(s)
        if verdict == "UNSAT":
            return FormalResult(UNSAT, self.stats)
        if verdict != "SAT":
            return FormalResult(UNPROVEN, self.stats)
        model = s.model()
        bits = tuple(
            model[var_of[p + 1]] if (p + 1) in var_of else 0
            for p in range(self.unet.n_pis))
        # replay on the unified netlist: the model must actually split
        # some output pair, else the engine (not the netlist) is broken
        words = pack_bits(np.array(bits, np.uint8)[:, None])
        vals = self.unet.simulate(words)

        def bit(lit: int) -> int:
            return int(vals[lit >> 1][0] & 1) ^ (lit & 1)

        if not any(bit(a) != bit(b) for a, b in pairs):
            self.stats["bad_cex"] = self.stats.get("bad_cex", 0) + 1
            return FormalResult(UNPROVEN, self.stats)
        return FormalResult(SAT, self.stats, cex=bits)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def prove_pairs(unet: UNet, outs_a: Sequence[int], outs_b: Sequence[int],
                care: Optional[CareSet] = None,
                conflict_budget: int = DEFAULT_CONFLICT_BUDGET,
                seed: int = 0, sim_words: int = _SIM_WORDS) -> FormalResult:
    """Prove pointwise equality of two output-literal lists of a UNet."""
    eng = _Engine(unet, care, conflict_budget, seed)
    return eng.prove(list(zip(outs_a, outs_b)), sim_words=sim_words)


def prove_aig_equiv(ref: AIG, dut: AIG, *, care: Optional[CareSet] = None,
                    conflict_budget: int = DEFAULT_CONFLICT_BUDGET,
                    seed: int = 0) -> FormalResult:
    unet = UNet(ref.n_pis)
    oa = import_aig(unet, ref)
    ob = import_aig(unet, dut)
    return prove_pairs(unet, oa, ob, care, conflict_budget, seed)


def prove_aig_mapped(aig: AIG, mapped, *, care: Optional[CareSet] = None,
                     conflict_budget: int = DEFAULT_CONFLICT_BUDGET,
                     seed: int = 0) -> FormalResult:
    unet = UNet(aig.n_pis)
    oa = import_aig(unet, aig)
    ob = import_mapped(unet, mapped)
    return prove_pairs(unet, oa, ob, care, conflict_budget, seed)


def prove_mapped_equiv(a, b, *, care: Optional[CareSet] = None,
                       conflict_budget: int = DEFAULT_CONFLICT_BUDGET,
                       seed: int = 0) -> FormalResult:
    unet = UNet(a.n_pis)
    oa = import_mapped(unet, a)
    ob = import_mapped(unet, b)
    return prove_pairs(unet, oa, ob, care, conflict_budget, seed)


def prove_mapped_plan(mapped, dplan, *, care: Optional[CareSet] = None,
                      conflict_budget: int = DEFAULT_CONFLICT_BUDGET,
                      seed: int = 0) -> FormalResult:
    unet = UNet(mapped.n_pis)
    oa = import_mapped(unet, mapped)
    ob = import_plan(unet, dplan)
    return prove_pairs(unet, oa, ob, care, conflict_budget, seed)


def prove_network_mapped(net, mapped, *,
                         conflict_budget: int = DEFAULT_CONFLICT_BUDGET,
                         seed: int = 0) -> FormalResult:
    """LogicNetwork (via its SOP-derived AIG) <-> mapped netlist, on the
    quantizer care set: unreachable activation codes are excluded by
    CNF blocking clauses, exactly mirroring espresso's don't-cares."""
    from repro_torch.synth.from_sop import network_to_aig
    ref = network_to_aig(net)
    unet = UNet(ref.n_pis)
    oa = import_aig(unet, ref)
    ob = import_mapped(unet, mapped)
    return prove_pairs(unet, oa, ob, CareSet.from_network(net),
                       conflict_budget, seed)
