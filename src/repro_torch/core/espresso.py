"""espresso-lite: two-level logic minimization (NullaNet Tiny step 4).

The paper uses ESPRESSO-II. We implement the same EXPAND / IRREDUNDANT
loop specialised to *completely-specified* single-output functions given
as dense on-set bitmaps over K <= ~16 variables — exactly what
truth-table extraction produces. (An optional don't-care set is honoured;
NullaNet-2018-style partial enumeration produces DCs, NullaNet Tiny's
full enumeration does not.)

Cube representation: int8 vector of length K with entries
  0 = negative literal, 1 = positive literal, 2 = free (don't-care).

For K <= 16 the dense bitmap (2^K bools) makes the two critical
predicates — "cube inside on+dc" and "rows covered by cube" — cheap,
vectorised numpy operations, so the minimizer is fast enough to run over
every neuron of the JSC networks inside the test suite.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

FREE = 2


@dataclasses.dataclass
class Cover:
    """A sum-of-products cover: cubes (C, K) int8 plus bookkeeping."""

    cubes: np.ndarray  # (C, K) int8 in {0, 1, FREE}
    n_vars: int

    @property
    def n_cubes(self) -> int:
        return int(self.cubes.shape[0])

    @property
    def n_literals(self) -> int:
        return int(np.sum(self.cubes != FREE))

    def support(self) -> np.ndarray:
        """Variables actually used by the cover."""
        if self.n_cubes == 0:
            return np.zeros(self.n_vars, bool)
        return np.any(self.cubes != FREE, axis=0)


def _rows_of_cube(cube: np.ndarray) -> np.ndarray:
    """Row indices (little-endian var 0 = bit 0) covered by a cube."""
    k = cube.shape[0]
    fixed = 0
    free_bits: List[int] = []
    for v in range(k):
        if cube[v] == 1:
            fixed |= 1 << v
        elif cube[v] == FREE:
            free_bits.append(v)
    rows = np.zeros(1 << len(free_bits), dtype=np.int64)
    for i, v in enumerate(free_bits):
        half = 1 << i
        rows[half: 2 * half] = rows[:half] + (1 << v)
    return rows + fixed


def cube_covers(cube: np.ndarray) -> np.ndarray:
    return _rows_of_cube(cube)


def _cube_inside(cube: np.ndarray, allowed: np.ndarray) -> bool:
    """True iff every row of the cube lies in the allowed (on+dc) set."""
    return bool(np.all(allowed[_rows_of_cube(cube)]))


def _expand_cube(cube: np.ndarray, allowed: np.ndarray,
                 order: Sequence[int]) -> np.ndarray:
    """EXPAND: greedily free literals while the cube stays inside on+dc."""
    cube = cube.copy()
    for v in order:
        if cube[v] == FREE:
            continue
        saved = cube[v]
        cube[v] = FREE
        if not _cube_inside(cube, allowed):
            cube[v] = saved
    return cube


def minimize(onset: np.ndarray, dc: Optional[np.ndarray] = None,
             n_vars: Optional[int] = None) -> Cover:
    """Two-level minimization of a dense on-set bitmap.

    onset: (2^K,) bool. dc: optional (2^K,) bool don't-care set.
    Returns an irredundant prime cover (greedy; espresso-quality, not
    guaranteed minimum — same contract as ESPRESSO-II).
    """
    onset = np.asarray(onset, bool)
    n_rows = onset.shape[0]
    if n_vars is None:
        n_vars = int(n_rows).bit_length() - 1
    assert 1 << n_vars == n_rows, "onset length must be 2^K"
    if dc is None:
        dc = np.zeros(n_rows, bool)
    allowed = onset | dc

    on_rows = np.nonzero(onset)[0]
    if len(on_rows) == 0:
        return Cover(np.zeros((0, n_vars), np.int8), n_vars)
    if np.all(allowed):
        return Cover(np.full((1, n_vars), FREE, np.int8), n_vars)

    # --- EXPAND: one prime per on-set minterm (dedup as we go) ---------
    # Variable order heuristic: free the variable whose column is most
    # "balanced" in the on-set last (it is most likely to be essential).
    col_ones = np.array([
        int(np.sum((on_rows >> v) & 1)) for v in range(n_vars)])
    balance = np.minimum(col_ones, len(on_rows) - col_ones)
    order = list(np.argsort(balance))  # least balanced freed first

    covered = np.zeros(n_rows, bool)
    primes: List[np.ndarray] = []
    seen = set()
    for r in on_rows:
        if covered[r]:
            continue
        cube = np.array([(r >> v) & 1 for v in range(n_vars)], np.int8)
        cube = _expand_cube(cube, allowed, order)
        key = cube.tobytes()
        if key not in seen:
            seen.add(key)
            primes.append(cube)
            covered[_rows_of_cube(cube)] = True

    # --- IRREDUNDANT: greedy minimum-ish cover of the on-set ------------
    prime_rows = [
        np.intersect1d(_rows_of_cube(c), on_rows, assume_unique=False)
        for c in primes]
    need = np.zeros(n_rows, bool)
    need[on_rows] = True
    chosen: List[int] = []
    remaining = int(need.sum())
    gains = [len(pr) for pr in prime_rows]
    alive = [True] * len(primes)
    while remaining > 0:
        best, best_gain = -1, 0
        for i, pr in enumerate(prime_rows):
            if not alive[i]:
                continue
            g = int(np.sum(need[pr]))
            gains[i] = g
            if g > best_gain:
                best, best_gain = i, g
        if best < 0:
            break  # should not happen for complete covers
        chosen.append(best)
        alive[best] = False
        need[prime_rows[best]] = False
        remaining = int(need.sum())

    cubes = np.stack([primes[i] for i in chosen]) if chosen else \
        np.zeros((0, n_vars), np.int8)
    return Cover(cubes, n_vars)


def evaluate(cover: Cover, n_rows: Optional[int] = None) -> np.ndarray:
    """Dense bitmap realised by a cover (for verification)."""
    n_rows = n_rows or (1 << cover.n_vars)
    out = np.zeros(n_rows, bool)
    for c in cover.cubes:
        out[_rows_of_cube(c)] = True
    return out


def verify(cover: Cover, onset: np.ndarray,
           dc: Optional[np.ndarray] = None) -> bool:
    """Cover must equal the on-set outside the DC set."""
    got = evaluate(cover, onset.shape[0])
    care = ~dc if dc is not None else np.ones_like(onset)
    return bool(np.all(got[care] == np.asarray(onset, bool)[care]))


def cover_to_sop_str(cover: Cover, var_names: Optional[Sequence[str]] = None
                     ) -> str:
    """Human/Verilog-readable SOP string, e.g. "(a&~b) | (c)"."""
    if cover.n_cubes == 0:
        return "1'b0"
    names = var_names or [f"x{v}" for v in range(cover.n_vars)]
    terms = []
    for c in cover.cubes:
        lits = []
        for v in range(cover.n_vars):
            if c[v] == 1:
                lits.append(names[v])
            elif c[v] == 0:
                lits.append("~" + names[v])
        terms.append("(" + " & ".join(lits) + ")" if lits else "1'b1")
    return " | ".join(terms)
