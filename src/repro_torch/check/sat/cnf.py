"""CNF construction for the formal equivalence engine.

Builds clause sets in the same literal encoding as :mod:`.solver`
(variable ``v`` -> literals ``2v`` / ``2v+1``).  Three gate encodings:

  * ``and_clauses`` — Tseitin encoding of a 2-input AND
    (``out <-> a & b``, 3 clauses);
  * ``lut_clauses(mode="rows")`` — one clause per INIT row: for minterm
    ``r`` the clause "inputs differ from r, or out takes tt[r]"
    (``2^m`` clauses, exact);
  * ``lut_clauses(mode="isop")`` — irredundant sum-of-products via the
    Minato-Morreale ISOP recursion over the truth table and its
    complement: onset cubes imply ``out``, offset cubes imply ``¬out``
    (usually far fewer clauses than per-row for structured INITs).

``care_code_clauses`` encodes the quantizer care set: for every
*invalid* code of a PI bit-group, one clause blocking that assignment —
the miter is then proved only over reachable activations, matching
espresso's don't-care treatment exactly.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

Cube = Tuple[int, int]   # (pos_mask, neg_mask) over local var indices


class CNF:
    """A growable clause set; feeds :class:`~.solver.Solver`."""

    def __init__(self):
        self.n_vars = 0
        self.clauses: List[List[int]] = []

    def new_var(self) -> int:
        v = self.n_vars
        self.n_vars += 1
        return v

    def add(self, *lits: int) -> None:
        self.clauses.append(list(lits))

    def solver(self):
        from .solver import Solver
        s = Solver(self.n_vars)
        for c in self.clauses:
            if not s.add_clause(c):
                break
        return s


def and_clauses(cnf: CNF, out: int, a: int, b: int) -> None:
    """Tseitin ``out <-> a AND b`` (literals, complement via ``^1``)."""
    cnf.add(out ^ 1, a)
    cnf.add(out ^ 1, b)
    cnf.add(out, a ^ 1, b ^ 1)


def xor_clauses(cnf: CNF, out: int, a: int, b: int) -> None:
    """Tseitin ``out <-> a XOR b`` (4 clauses)."""
    cnf.add(out ^ 1, a, b)
    cnf.add(out ^ 1, a ^ 1, b ^ 1)
    cnf.add(out, a, b ^ 1)
    cnf.add(out, a ^ 1, b)


def equal_clauses(cnf: CNF, a: int, b: int) -> None:
    """Force ``a == b``."""
    cnf.add(a ^ 1, b)
    cnf.add(a, b ^ 1)


# --------------------------------------------------------------- ISOP
def isop(tt: int, m: int) -> List[Cube]:
    """Irredundant sum-of-products of an ``m``-input truth table.

    Minato-Morreale recursion computing a cover between lower bound
    ``L`` (must cover) and upper bound ``U`` (may cover); called with
    ``L == U == tt`` it returns an exact irredundant cover.  Cubes are
    ``(pos_mask, neg_mask)`` bitmasks over input indices.
    """
    full = (1 << (1 << m)) - 1
    cubes, cover = _isop(tt & full, tt & full, m)
    assert cover == tt & full
    return cubes


def _isop(L: int, U: int, m: int) -> Tuple[List[Cube], int]:
    if L == 0:
        return [], 0
    full = (1 << (1 << m)) - 1
    if U == full:
        return [(0, 0)], full
    assert m > 0
    half = 1 << (m - 1)
    lo_mask = (1 << half) - 1
    L0, L1 = L & lo_mask, L >> half
    U0, U1 = U & lo_mask, U >> half
    var = m - 1
    # cubes that must carry ¬x (cover onset rows not allowed under x)
    c0, cov0 = _isop(L0 & ~U1 & lo_mask, U0, m - 1)
    # cubes that must carry x
    c1, cov1 = _isop(L1 & ~U0 & lo_mask, U1, m - 1)
    # remainder is covered independently of x
    Lrest = (L0 & ~cov0 & lo_mask) | (L1 & ~cov1 & lo_mask)
    cd, covd = _isop(Lrest, U0 & U1, m - 1)
    cubes = ([(p, n | (1 << var)) for p, n in c0]
             + [(p | (1 << var), n) for p, n in c1]
             + cd)
    cover = ((cov0 | covd) & lo_mask) | (((cov1 | covd) & lo_mask) << half)
    return cubes, cover


def eval_cubes(cubes: Sequence[Cube], m: int) -> int:
    """Truth table of a cube cover (for testing ISOP round-trips)."""
    tt = 0
    for r in range(1 << m):
        for p, n in cubes:
            if (r & p) == p and (r & n) == 0:
                tt |= 1 << r
                break
    return tt


@lru_cache(maxsize=4096)
def _isop_cached(tt: int, m: int) -> Tuple[Tuple[Cube, ...], Tuple[Cube, ...]]:
    full = (1 << (1 << m)) - 1
    return tuple(isop(tt, m)), tuple(isop(~tt & full, m))


# ---------------------------------------------------------------- LUTs
def lut_clauses(cnf: CNF, out: int, in_lits: Sequence[int], tt: int,
                mode: str = "isop") -> None:
    """Constrain ``out`` to the ``tt``-function of ``in_lits``.

    ``mode="rows"``: one clause per INIT row.  ``mode="isop"``: onset
    cubes imply ``out``, offset cubes imply ``¬out`` (cached per tt).
    """
    m = len(in_lits)
    full = (1 << (1 << m)) - 1
    tt &= full
    if m == 0:
        cnf.add(out ^ (0 if tt & 1 else 1))
        return
    if mode == "rows":
        for r in range(1 << m):
            head = out if (tt >> r) & 1 else out ^ 1
            clause = [head]
            for j, l in enumerate(in_lits):
                # block row r: literal true iff input j differs from r_j
                clause.append(l ^ 1 if (r >> j) & 1 else l)
            cnf.add(*clause)
        return
    if mode != "isop":
        raise ValueError(f"unknown LUT encoding mode: {mode!r}")
    on, off = _isop_cached(tt, m)
    for cubes, head in ((on, out), (off, out ^ 1)):
        for p, n in cubes:
            clause = [head]
            for j, l in enumerate(in_lits):
                if (p >> j) & 1:
                    clause.append(l ^ 1)
                elif (n >> j) & 1:
                    clause.append(l)
            cnf.add(*clause)


# ------------------------------------------------------------ care set
def care_code_clauses(cnf: CNF, group_lits: Sequence[int],
                      n_valid: int) -> None:
    """Restrict a little-endian bit-group to codes ``< n_valid``.

    One blocking clause per invalid code — e.g. a "signed" 2-bit
    activation with 3 levels gets the single clause ``(¬b0 ∨ ¬b1)``
    ruling code 3 out of the miter's search space.
    """
    bits = len(group_lits)
    for code in range(n_valid, 1 << bits):
        clause = []
        for b, l in enumerate(group_lits):
            clause.append(l ^ 1 if (code >> b) & 1 else l)
        cnf.add(*clause)


def miter_clauses(cnf: CNF, pairs: Sequence[Tuple[int, int]]) -> None:
    """Assert "some pair differs": XOR each pair, OR the XORs.

    A satisfying assignment is a counterexample; UNSAT proves the pairs
    pointwise equal (over whatever care clauses are present).
    """
    if len(pairs) == 1:
        a, b = pairs[0]
        # inequality directly, no fresh var needed
        cnf.add(a, b)
        cnf.add(a ^ 1, b ^ 1)
        return
    diffs = []
    for a, b in pairs:
        d = 2 * cnf.new_var()
        xor_clauses(cnf, d, a, b)
        diffs.append(d)
    cnf.add(*diffs)
