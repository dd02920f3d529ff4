"""Self-contained CDCL SAT solver (MiniSat-style, pure stdlib).

The formal equivalence engine needs exact answers on miter CNFs whose
cones exceed the 20-PI exhaustive limit.  External solvers are off the
table (no new deps), so this module implements the classic conflict-
driven clause-learning loop:

  * two-watched-literal unit propagation (watch invariant: the first
    two literals of every clause are the watched ones);
  * first-UIP conflict analysis with on-the-fly variable bumping;
  * VSIDS-style decision heuristic (activity heap with lazy deletion)
    plus phase saving;
  * Luby-sequence restarts;
  * a learned-clause database reduced by activity when it outgrows a
    geometrically increasing cap;
  * a *conflict budget*: ``solve`` returns ``UNKNOWN`` instead of
    looping forever, which the engine maps to an ``UNPROVEN`` verdict
    and a fall back to sampling.

Literal encoding matches the AIG convention used across ``repro_torch.synth``:
variable ``v`` (0-based) has positive literal ``2*v`` and negative
literal ``2*v + 1``; ``lit ^ 1`` negates.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence

SAT = "SAT"
UNSAT = "UNSAT"
UNKNOWN = "UNKNOWN"

_RESCALE = 1e100
_VAR_DECAY = 0.95
_CLA_DECAY = 0.999
_RESTART_UNIT = 128          # Luby base, in conflicts


def luby(i: int) -> int:
    """i-th term (1-based) of the Luby restart sequence 1,1,2,1,1,2,4,…"""
    while True:
        k = 1
        while (1 << k) - 1 < i:
            k += 1
        if (1 << k) - 1 == i:
            return 1 << (k - 1)
        i -= (1 << (k - 1)) - 1


class _Clause:
    __slots__ = ("lits", "learned", "act")

    def __init__(self, lits: List[int], learned: bool):
        self.lits = lits
        self.learned = learned
        self.act = 0.0


class Solver:
    """CDCL solver over literals ``2*var | sign`` (sign 1 = negated)."""

    def __init__(self, n_vars: int = 0):
        self.n_vars = 0
        self.assigns: List[int] = []       # -1 unassigned / 0 false / 1 true
        self.level: List[int] = []
        self.reason: List[Optional[_Clause]] = []
        self.watches: List[List[_Clause]] = []
        self.activity: List[float] = []
        self.polarity: List[int] = []      # saved phase (1 = last true)
        self.trail: List[int] = []
        self.trail_lim: List[int] = []
        self.qhead = 0
        self.clauses: List[_Clause] = []
        self.learnts: List[_Clause] = []
        self.var_inc = 1.0
        self.cla_inc = 1.0
        self._heap: List = []              # (-activity, var), lazy deletes
        self.ok = True
        self.stats: Dict[str, int] = {
            "conflicts": 0, "decisions": 0, "propagations": 0,
            "restarts": 0, "learned": 0, "db_reductions": 0,
        }
        for _ in range(n_vars):
            self.new_var()

    # ------------------------------------------------------------- setup
    def new_var(self) -> int:
        v = self.n_vars
        self.n_vars += 1
        self.assigns.append(-1)
        self.level.append(-1)
        self.reason.append(None)
        self.watches.append([])
        self.watches.append([])
        self.activity.append(0.0)
        self.polarity.append(0)
        heapq.heappush(self._heap, (0.0, v))
        return v

    def value(self, lit: int) -> int:
        va = self.assigns[lit >> 1]
        return va if va < 0 else va ^ (lit & 1)

    def add_clause(self, lits: Sequence[int]) -> bool:
        """Add a problem clause; returns False on a root-level conflict."""
        if not self.ok:
            return False
        seen = set()
        out: List[int] = []
        for l in lits:
            if l ^ 1 in seen:
                return True                          # tautology
            if l in seen:
                continue
            if self.value(l) == 1 and self.level[l >> 1] == 0:
                return True                          # already satisfied
            if self.value(l) == 0 and self.level[l >> 1] == 0:
                continue                             # falsified at root
            seen.add(l)
            out.append(l)
        if not out:
            self.ok = False
            return False
        if len(out) == 1:
            if not self._enqueue(out[0], None):
                self.ok = False
                return False
            self.ok = self._propagate() is None
            return self.ok
        c = _Clause(out, learned=False)
        self.clauses.append(c)
        self._watch(c)
        return True

    def _watch(self, c: _Clause) -> None:
        self.watches[c.lits[0] ^ 1].append(c)
        self.watches[c.lits[1] ^ 1].append(c)

    # ------------------------------------------------------ assignments
    def _enqueue(self, lit: int, frm: Optional[_Clause]) -> bool:
        val = self.value(lit)
        if val >= 0:
            return val == 1
        v = lit >> 1
        self.assigns[v] = 1 - (lit & 1)
        self.level[v] = len(self.trail_lim)
        self.reason[v] = frm
        self.polarity[v] = 1 - (lit & 1)
        self.trail.append(lit)
        return True

    def _propagate(self) -> Optional[_Clause]:
        while self.qhead < len(self.trail):
            p = self.trail[self.qhead]
            self.qhead += 1
            self.stats["propagations"] += 1
            ws = self.watches[p]
            self.watches[p] = []
            i = 0
            n = len(ws)
            while i < n:
                c = ws[i]
                i += 1
                lits = c.lits
                # ensure the falsified watch (¬p) sits at slot 1
                if lits[0] == p ^ 1:
                    lits[0], lits[1] = lits[1], lits[0]
                if self.value(lits[0]) == 1:
                    self.watches[p].append(c)
                    continue
                moved = False
                for j in range(2, len(lits)):
                    if self.value(lits[j]) != 0:
                        lits[1], lits[j] = lits[j], lits[1]
                        self.watches[lits[1] ^ 1].append(c)
                        moved = True
                        break
                if moved:
                    continue
                # unit or conflicting
                self.watches[p].append(c)
                if not self._enqueue(lits[0], c):
                    self.watches[p].extend(ws[i:])
                    self.qhead = len(self.trail)
                    return c
        return None

    # -------------------------------------------------------- conflicts
    def _bump_var(self, v: int) -> None:
        self.activity[v] += self.var_inc
        if self.activity[v] > _RESCALE:
            inv = 1.0 / _RESCALE
            for u in range(self.n_vars):
                self.activity[u] *= inv
            self.var_inc *= inv
        heapq.heappush(self._heap, (-self.activity[v], v))

    def _bump_cla(self, c: _Clause) -> None:
        c.act += self.cla_inc
        if c.act > _RESCALE:
            inv = 1.0 / _RESCALE
            for d in self.learnts:
                d.act *= inv
            self.cla_inc *= inv

    def _analyze(self, confl: _Clause):
        learnt: List[int] = [0]
        seen = bytearray(self.n_vars)
        counter = 0
        p = -1
        index = len(self.trail) - 1
        cur_level = len(self.trail_lim)
        c: Optional[_Clause] = confl
        while True:
            assert c is not None
            if c.learned:
                self._bump_cla(c)
            for q in c.lits:
                if q == p:
                    continue
                v = q >> 1
                if not seen[v] and self.level[v] > 0:
                    seen[v] = 1
                    self._bump_var(v)
                    if self.level[v] >= cur_level:
                        counter += 1
                    else:
                        learnt.append(q)
            while not seen[self.trail[index] >> 1]:
                index -= 1
            p = self.trail[index]
            v = p >> 1
            c = self.reason[v]
            seen[v] = 0
            index -= 1
            counter -= 1
            if counter == 0:
                break
        learnt[0] = p ^ 1
        if len(learnt) == 1:
            bt = 0
        else:
            # move the highest-level tail literal to slot 1 (watch it)
            mi = 1
            for j in range(2, len(learnt)):
                if self.level[learnt[j] >> 1] > self.level[learnt[mi] >> 1]:
                    mi = j
            learnt[1], learnt[mi] = learnt[mi], learnt[1]
            bt = self.level[learnt[1] >> 1]
        return learnt, bt

    def _backtrack(self, lvl: int) -> None:
        if len(self.trail_lim) <= lvl:
            return
        bound = self.trail_lim[lvl]
        for i in range(len(self.trail) - 1, bound - 1, -1):
            v = self.trail[i] >> 1
            self.assigns[v] = -1
            self.reason[v] = None
            heapq.heappush(self._heap, (-self.activity[v], v))
        del self.trail[bound:]
        del self.trail_lim[lvl:]
        self.qhead = len(self.trail)

    # -------------------------------------------------------- decisions
    def _pick_branch(self) -> int:
        while self._heap:
            act, v = heapq.heappop(self._heap)
            if self.assigns[v] < 0 and -act == self.activity[v]:
                return v
        for v in range(self.n_vars):          # heap starved: linear scan
            if self.assigns[v] < 0:
                return v
        return -1

    # ---------------------------------------------------------- DB care
    def _reduce_db(self) -> None:
        self.stats["db_reductions"] += 1
        locked = {id(self.reason[l >> 1]) for l in self.trail
                  if self.reason[l >> 1] is not None}
        self.learnts.sort(key=lambda c: c.act)
        keep: List[_Clause] = []
        half = len(self.learnts) // 2
        for i, c in enumerate(self.learnts):
            if len(c.lits) <= 2 or id(c) in locked or i >= half:
                keep.append(c)
        kept = {id(c) for c in keep}
        self.learnts = keep
        for wl in range(2 * self.n_vars):
            self.watches[wl] = [c for c in self.watches[wl]
                                if not c.learned or id(c) in kept]

    # ------------------------------------------------------------ solve
    def solve(self, conflict_budget: Optional[int] = None) -> str:
        """Run CDCL search; returns ``SAT`` / ``UNSAT`` / ``UNKNOWN``.

        After ``SAT`` the model is in :attr:`assigns` (see
        :meth:`model`); ``UNKNOWN`` means the conflict budget ran out.
        """
        if not self.ok:
            return UNSAT
        if self._propagate() is not None:
            self.ok = False
            return UNSAT
        max_learnts = max(1000, len(self.clauses) // 3)
        restart_idx = 1
        restart_lim = luby(restart_idx) * _RESTART_UNIT
        since_restart = 0
        while True:
            confl = self._propagate()
            if confl is not None:
                self.stats["conflicts"] += 1
                since_restart += 1
                if not self.trail_lim:
                    self.ok = False
                    return UNSAT
                learnt, bt = self._analyze(confl)
                self._backtrack(bt)
                if len(learnt) == 1:
                    self._enqueue(learnt[0], None)
                else:
                    c = _Clause(learnt, learned=True)
                    c.act = self.cla_inc
                    self.learnts.append(c)
                    self.stats["learned"] += 1
                    self._watch(c)
                    self._enqueue(learnt[0], c)
                self.var_inc /= _VAR_DECAY
                self.cla_inc /= _CLA_DECAY
                if (conflict_budget is not None
                        and self.stats["conflicts"] >= conflict_budget):
                    self._backtrack(0)
                    return UNKNOWN
                if since_restart >= restart_lim:
                    self.stats["restarts"] += 1
                    restart_idx += 1
                    restart_lim = luby(restart_idx) * _RESTART_UNIT
                    since_restart = 0
                    self._backtrack(0)
                if len(self.learnts) >= max_learnts + len(self.trail):
                    self._reduce_db()
                    max_learnts = int(max_learnts * 1.5)
            else:
                v = self._pick_branch()
                if v < 0:
                    return SAT
                self.stats["decisions"] += 1
                self.trail_lim.append(len(self.trail))
                self._enqueue(2 * v | (self.polarity[v] ^ 1), None)

    def model(self) -> List[int]:
        """Assignment after ``SAT``: ``model()[v]`` is 0/1 (unassigned
        vars default to 0)."""
        return [a if a >= 0 else 0 for a in self.assigns]
