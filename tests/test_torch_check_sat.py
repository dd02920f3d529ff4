"""repro_torch.check.sat against repro.check.sat: the formal engine
proves what sampling can only sample, with the same verdicts,
counterexamples and statistics in both packages.

Each test ports one of the reference's ``tests/test_check_sat.py``
(same name), runs the same inputs through both packages' solver, CNF
encodings, unified netlist and sweep, and holds the port to the
reference's results and to the reference test's own assertions. The
ISOP test checks ``eval_cubes(isop(tt, m), m) == tt`` (the reference's
copy calls ``eval_cubes`` with a row where it takes ``m``).
"""
import dataclasses

import numpy as np
import pytest
from hyp_compat import given, settings, st

import repro.check as RC
import repro.check.sat as RSAT
import repro.synth as RS
from repro.check.sat import cnf as ref_cnf
from repro.check.sat import engine as ref_engine
from repro.check.sat.solver import Solver as RefSolver
from repro.check.sat.solver import luby as ref_luby
from repro.synth.executor import execute_packed as ref_execute_packed
from repro.synth.lutmap import MappedLUT as RefMappedLUT
from repro.synth.lutmap import MappedNetwork as RefMappedNetwork
from repro_torch.check import (equiv_aig_mapped, find_duplicate_lut_outputs,
                               merge_duplicate_lut_outputs, prove_aig_equiv,
                               prove_aig_mapped, prove_mapped_equiv)
from repro_torch.check.sat import CareSet, prove_pairs
from repro_torch.check.sat.cnf import CNF, eval_cubes, isop, lut_clauses
from repro_torch.check.sat.engine import (UNet, _normalize, import_aig,
                                          import_mapped)
from repro_torch.check.sat.solver import Solver, luby
from repro_torch import synth as PSY
from repro_torch.synth import AIG, lit, map_aig, optimize
from repro_torch.synth.executor import execute_packed
from repro_torch.synth.lutmap import MappedLUT, MappedNetwork
from repro_torch.synth.simulate import input_patterns, pack_bits


def random_aig(seed, n_pis=26, n_ands=150, n_outs=4, synth=PSY):
    rng = np.random.default_rng(seed)
    a = synth.AIG(n_pis)
    lits = [synth.lit(p + 1) for p in range(n_pis)]
    for _ in range(n_ands):
        i, j = rng.integers(0, len(lits), 2)
        lits.append(a.and2(lits[i] ^ int(rng.integers(2)),
                           lits[j] ^ int(rng.integers(2))))
    a.outputs = lits[-n_outs:]
    return a


def ref_aig(seed, **kw):
    return random_aig(seed, synth=RS, **kw)


def to_ref(mapped):
    """The reference package's copy of a port mapped netlist."""
    return RefMappedNetwork(mapped.n_pis, mapped.k,
                            [RefMappedLUT(l.root, l.leaves, l.tt)
                             for l in mapped.luts], list(mapped.outputs))


def same_result(port, ref):
    assert (port.verdict, port.cex, port.stats) == \
        (ref.verdict, ref.cex, ref.stats)


def rare_minterm_net(n=26, synth=PSY):
    """(aig, mapped, mutated mapped, target bits): output is 1 on exactly
    one non-corner input (x1..x24 & ~x25 & ~x26); the mutation flips
    the mapped INIT row selected by that input, so the two sides differ
    on a single minterm out of 2^26."""
    a = synth.AIG(n)
    acc = synth.lit(1)
    for p in range(2, n - 1):
        acc = a.and2(acc, synth.lit(p))
    acc = a.and2(acc, synth.lit(n - 1) ^ 1)
    acc = a.and2(acc, synth.lit(n) ^ 1)
    a.outputs = [acc]
    mapped = synth.map_aig(a)
    target = np.array([1] * (n - 2) + [0, 0], np.uint8)
    wirevals = {p: int(target[p - 1]) for p in range(1, n + 1)}
    for l in mapped.luts:
        row = sum(wirevals[leaf] << j for j, leaf in enumerate(l.leaves))
        wirevals[l.root] = (l.tt >> row) & 1
    root_i = next(i for i, l in enumerate(mapped.luts)
                  if l.root == (mapped.outputs[0] >> 1))
    l = mapped.luts[root_i]
    row = sum(wirevals[leaf] << j for j, leaf in enumerate(l.leaves))
    luts = list(mapped.luts)
    luts[root_i] = synth.MappedLUT(l.root, l.leaves, l.tt ^ (1 << row))
    bad = synth.MappedNetwork(mapped.n_pis, mapped.k, luts, mapped.outputs)
    return a, mapped, bad, target


# ---------------------------------------------------------------------------
# the CDCL solver
# ---------------------------------------------------------------------------

def _brute_sat(n, clauses):
    for m in range(1 << n):
        if all(any(((m >> (l >> 1)) & 1) ^ (l & 1) for l in c)
               for c in clauses):
            return True
    return False


def test_solver_matches_brute_force():
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(3, 9))
        clauses = [[2 * int(v) | int(rng.integers(2))
                    for v in rng.choice(n, int(rng.integers(1, 4)),
                                        replace=False)]
                   for _ in range(int(rng.integers(4, 40)))]
        s, r = Solver(n), RefSolver(n)
        for c in clauses:
            s.add_clause(c)
            r.add_clause(c)
        verdict = s.solve()
        assert verdict == r.solve()
        assert verdict == ("SAT" if _brute_sat(n, clauses) else "UNSAT")
        if verdict == "SAT":
            m = s.model()
            assert m == r.model()
            assert all(any(m[l >> 1] ^ (l & 1) for l in c)
                       for c in clauses)


def test_solver_budget_yields_unknown():
    # 8-hole pigeonhole: hard UNSAT; a 1-conflict budget cannot finish
    n_p, n_h = 9, 8
    for cls in (Solver, RefSolver):
        s = cls(n_p * n_h)
        v = lambda p, h: p * n_h + h  # noqa: E731
        for p in range(n_p):
            s.add_clause([2 * v(p, h) for h in range(n_h)])
        for h in range(n_h):
            for p1 in range(n_p):
                for p2 in range(p1 + 1, n_p):
                    s.add_clause([2 * v(p1, h) ^ 1, 2 * v(p2, h) ^ 1])
        assert s.solve(conflict_budget=1) == "UNKNOWN"


def test_luby_sequence():
    assert [luby(i) for i in range(1, 10)] == [1, 1, 2, 1, 1, 2, 4, 1, 1]
    assert [luby(i) for i in range(1, 64)] == \
        [ref_luby(i) for i in range(1, 64)]


# ---------------------------------------------------------------------------
# CNF encodings
# ---------------------------------------------------------------------------

@settings(deadline=None, max_examples=60)
@given(st.integers(min_value=2, max_value=4), st.integers(min_value=0))
def test_isop_cover_matches_table(m, tt_seed):
    tt = tt_seed % (1 << (1 << m))
    cubes = isop(tt, m)
    assert cubes == ref_cnf.isop(tt, m)
    assert eval_cubes(cubes, m) == tt


@pytest.mark.parametrize("mode", ["isop", "rows"])
def test_lut_clauses_exact(mode):
    """Force every input assignment; the out var must be forced to the
    table row — both encodings, all 2-input tables and 20 random
    3-input ones; the clauses are the reference's."""
    rng = np.random.default_rng(1)
    for tt in list(range(16)) + [int(rng.integers(0, 256))
                                 for _ in range(20)]:
        m = 3 if tt >= 16 else 2
        tt %= 1 << (1 << m)
        for assign in range(1 << m):
            cnfs = []
            for C, clauses in ((CNF, lut_clauses),
                               (ref_cnf.CNF, ref_cnf.lut_clauses)):
                cnf = C()
                ins = [2 * cnf.new_var() for _ in range(m)]
                out = 2 * cnf.new_var()
                clauses(cnf, out, ins, tt, mode=mode)
                cnfs.append((cnf, ins, out))
            (cnf, ins, out), (rcnf, _, _) = cnfs
            assert cnf.clauses == rcnf.clauses
            for j, l in enumerate(ins):
                cnf.add(l ^ (0 if (assign >> j) & 1 else 1))
            want = (tt >> assign) & 1
            cnf.add(out ^ (0 if want else 1))
            assert cnf.solver().solve() == "SAT", (tt, assign, mode)
            cnf.add(out ^ (1 if want else 0))
            assert cnf.solver().solve() == "UNSAT", (tt, assign, mode)


def test_normalize_preserves_function():
    rng = np.random.default_rng(2)
    for _ in range(50):
        un, run = UNet(4), ref_engine.UNet(4)
        m = int(rng.integers(2, 5))
        fans = [int(f) for f in rng.integers(2, 10, m)]  # PI literals
        tt = int(rng.integers(0, 1 << (1 << m)))
        assert _normalize(fans, tt) == ref_engine._normalize(fans, tt)
        out = un.add(fans, tt)
        assert out == run.add(fans, tt)
        vals = un.simulate(input_patterns(4))
        got = vals[out >> 1] ^ (np.uint32(0xFFFFFFFF) if out & 1 else 0)
        want = np.zeros_like(got)
        for r in range(16):
            row = 0
            for j, f in enumerate(fans):
                bit = ((int(vals[f >> 1][0]) >> r) & 1) ^ (f & 1)
                row |= bit << j
            if (tt >> row) & 1:
                want[0] |= np.uint32(1 << r)
        assert int(got[0]) & 0xFFFF == int(want[0]) & 0xFFFF


# ---------------------------------------------------------------------------
# UNet import fidelity
# ---------------------------------------------------------------------------

def test_unet_simulate_matches_execute_packed():
    for seed in range(4):
        a = optimize(random_aig(seed, n_pis=8, n_ands=40), rounds=1)
        mapped = map_aig(a, k=4)
        un, run = UNet(8), ref_engine.UNet(8)
        outs = import_mapped(un, mapped)
        assert outs == ref_engine.import_mapped(run, to_ref(mapped))
        ra = RS.optimize(ref_aig(seed, n_pis=8, n_ands=40), rounds=1)
        assert import_aig(UNet(8), a) == ref_engine.import_aig(
            ref_engine.UNet(8), ra)
        words = input_patterns(8)
        vals = un.simulate(words)
        ref = execute_packed(mapped, words)
        for o, r in zip(outs, ref):
            got = vals[o >> 1] ^ (np.uint32(0xFFFFFFFF) if o & 1 else 0)
            np.testing.assert_array_equal(got, r)


# ---------------------------------------------------------------------------
# proofs on clean wide pipelines
# ---------------------------------------------------------------------------

def test_clean_wide_pipeline_proves_unsat():
    for seed in range(3):
        a, ra = random_aig(seed), ref_aig(seed)
        opt, ropt = optimize(a, rounds=1), RS.optimize(ra, rounds=1)
        mapped = map_aig(opt)
        res = prove_aig_equiv(a, opt)
        same_result(res, RC.prove_aig_equiv(ra, ropt))
        assert res.verdict == "UNSAT"
        res = prove_aig_mapped(opt, mapped)
        same_result(res, RC.prove_aig_mapped(ropt, to_ref(mapped)))
        assert res.verdict == "UNSAT"
        assert res.stats["outputs"] == len(opt.outputs)


def test_constant_output_leg_regression():
    """Miter leg that is a bare constant: the const-FALSE unit clause
    must still be emitted (a spurious SAT here once poisoned the whole
    verdict to UNPROVEN via the bad-cex guard)."""
    a = AIG(4)
    t1 = a.and2(lit(1), lit(2))
    t2 = a.and2(lit(1), lit(2) ^ 1)
    a.outputs = [a.and2(t1, t2) ^ 1]        # semantically const-true
    ra = RS.AIG(4)
    rt1 = ra.and2(RS.lit(1), RS.lit(2))
    rt2 = ra.and2(RS.lit(1), RS.lit(2) ^ 1)
    ra.outputs = [ra.and2(rt1, rt2) ^ 1]
    for outs, verdict in (([1], "UNSAT"), ([0], "SAT")):
        res = prove_aig_mapped(a, MappedNetwork(4, 6, [], outs))
        same_result(res, RC.prove_aig_mapped(
            ra, RefMappedNetwork(4, 6, [], outs)))
        assert res.verdict == verdict


# ---------------------------------------------------------------------------
# mutation kill-rate beyond the exhaustive limit
# ---------------------------------------------------------------------------

def test_rare_minterm_flip_missed_by_sampling_caught_by_sat():
    a, _clean, bad, target = rare_minterm_net()
    ra, _, rbad, _ = rare_minterm_net(synth=RS)
    rep = equiv_aig_mapped(a, bad)              # sampled only
    assert rep.ok                               # sampling misses the bug
    assert rep.checked == RC.equiv_aig_mapped(ra, rbad).checked
    rep = equiv_aig_mapped(a, bad, formal=True)
    ref = RC.equiv_aig_mapped(ra, rbad, formal=True)
    assert not rep.ok
    cexs = [i.counterexample for i in rep.errors if i.counterexample]
    assert cexs and cexs[0].formal
    assert [dataclasses.astuple(c) for c in cexs] == \
        [dataclasses.astuple(i.counterexample) for i in ref.errors
         if i.counterexample]
    res = prove_aig_mapped(a, bad)
    same_result(res, RC.prove_aig_mapped(ra, rbad))
    assert res.verdict == "SAT"
    assert res.cex == tuple(int(b) for b in target)


def test_counterexample_replays_through_bitplane_sim():
    a, clean, bad, _ = rare_minterm_net()
    res = prove_aig_mapped(a, bad)
    words = pack_bits(np.array(res.cex, np.uint8)[:, None])
    got = execute_packed(bad, words)
    want = execute_packed(clean, words)
    assert any(int(g[0] & 1) != int(w[0] & 1)
               for g, w in zip(got, want))
    np.testing.assert_array_equal(got, ref_execute_packed(to_ref(bad),
                                                          words))


def test_wide_mutations_all_yield_sat():
    """INIT flip / leaf swap on a 26-PI mapped net: every functional
    mutation comes back SAT with a replayable cex, as in the
    reference."""
    a = optimize(random_aig(7), rounds=1)
    ra = RS.optimize(ref_aig(7), rounds=1)
    mapped = map_aig(a)
    base = list(mapped.luts)

    def differs(m2):
        words = np.random.default_rng(5).integers(
            0, 1 << 32, (mapped.n_pis, 64), dtype=np.uint32)
        x, y = execute_packed(mapped, words), execute_packed(m2, words)
        return any(not np.array_equal(g, w) for g, w in zip(x, y))

    muts = []
    l = base[-1]
    muts.append(("init-flip", base[:-1]
                 + [MappedLUT(l.root, l.leaves, l.tt ^ 4)]))
    if len(l.leaves) >= 2:
        sw = (l.leaves[1], l.leaves[0]) + l.leaves[2:]
        muts.append(("leaf-swap", base[:-1]
                     + [MappedLUT(l.root, sw, l.tt)]))
    n_checked = 0
    for name, luts in muts:
        bad = MappedNetwork(mapped.n_pis, mapped.k, luts, mapped.outputs)
        if not differs(bad):        # symmetric table etc. — not a mutation
            continue
        res = prove_aig_mapped(a, bad)
        same_result(res, RC.prove_aig_mapped(ra, to_ref(bad)))
        assert res.verdict == "SAT", name
        words = pack_bits(np.array(res.cex, np.uint8)[:, None])
        x = execute_packed(mapped, words)
        y = execute_packed(bad, words)
        assert any(int(g[0] & 1) != int(w[0] & 1)
                   for g, w in zip(x, y)), name
        n_checked += 1
    assert n_checked


def test_dropped_lut_detected():
    a = optimize(random_aig(9), rounds=1)
    mapped = map_aig(a)
    victim = mapped.outputs[0] >> 1
    luts = [l for l in mapped.luts if l.root != victim]
    assert len(luts) < len(mapped.luts), "output fed directly by a PI"
    # rewire the dropped root to a PI so the netlist stays well-formed
    outs = [(2 * 1) | (o & 1) if (o >> 1) == victim else o
            for o in mapped.outputs]
    bad = MappedNetwork(mapped.n_pis, mapped.k, luts, outs)
    res = prove_mapped_equiv(mapped, bad)
    same_result(res, RC.prove_mapped_equiv(to_ref(mapped), to_ref(bad)))
    assert res.verdict == "SAT"


# ---------------------------------------------------------------------------
# budget exhaustion and care sets
# ---------------------------------------------------------------------------

def test_budget_zero_reports_unproven_and_falls_back():
    a = optimize(random_aig(3), rounds=1)
    mapped = map_aig(a)
    rep = equiv_aig_mapped(a, mapped, formal=True, conflict_budget=0)
    ref = RC.equiv_aig_mapped(RS.optimize(ref_aig(3), rounds=1),
                              to_ref(mapped), formal=True,
                              conflict_budget=0)
    assert rep.ok                       # sampled fallback found nothing
    assert any(i.severity == "warning" and "UNPROVEN" in i.message
               for i in rep.issues)
    assert rep.info["formal[aig-mapped]"]["verdict"] == "UNPROVEN"
    assert rep.info == ref.info and rep.checked == ref.checked
    assert [i.message for i in rep.issues] == [i.message for i in ref.issues]


def test_care_set_excludes_invalid_codes():
    """Two sides that differ ONLY on an invalid input code: SAT without
    the care set, UNSAT with it — exactly espresso's don't-care story."""
    n = 22                              # > exhaustive limit
    results = []
    for U, prove, Care in ((UNet, prove_pairs, CareSet),
                           (ref_engine.UNet, RSAT.prove_pairs,
                            RSAT.CareSet)):
        un = U(n)
        tail = 2 * 3
        for p in range(4, n + 1):
            tail = un.and2(tail, 2 * p)
        pair = un.and2(2 * 1, 2 * 2)    # 1 only on the invalid code 3
        side_a = un.and2(pair ^ 1, tail)
        side_b = tail                   # drops the (pair^1) factor
        care = Care((((0, 1), 3),))     # PIs 1,2 encode a 3-level code
        results.append((prove(un, [side_a], [side_b]),
                        prove(un, [side_a], [side_b], care=care)))
    (res, cared), (rres, rcared) = results
    same_result(res, rres)
    same_result(cared, rcared)
    assert res.verdict == "SAT"
    assert res.cex[0] == 1 and res.cex[1] == 1    # the invalid code
    assert cared.verdict == "UNSAT"


# ---------------------------------------------------------------------------
# SAT sweep: duplicate LUT outputs
# ---------------------------------------------------------------------------

def _dup_mapped(negated=False, ref=False):
    """Two LUTs computing the same (or complemented) function of the
    same PIs, plus an unrelated one."""
    L, N = (RefMappedLUT, RefMappedNetwork) if ref else (MappedLUT,
                                                        MappedNetwork)
    tt = 0b1000_0110_0110_1000  # some 4-input function
    full = (1 << 16) - 1
    luts = [
        L(5, (1, 2, 3, 4), tt),
        L(6, (1, 2, 3, 4), (~tt & full) if negated else tt),
        L(7, (2, 3), 0b0110),
    ]
    return N(4, 6, luts, [2 * 5, 2 * 6, 2 * 7])


@pytest.mark.parametrize("negated", [False, True])
def test_duplicate_lut_outputs_found_and_merged(negated):
    mapped = _dup_mapped(negated)
    pairs, stats = find_duplicate_lut_outputs(mapped)
    assert (pairs, stats) == RC.find_duplicate_lut_outputs(
        _dup_mapped(negated, ref=True))
    assert len(pairs) == 1
    keep, dup, neg = pairs[0]          # LUT indices, not root wires
    assert {keep, dup} == {0, 1} and neg == negated
    swept = merge_duplicate_lut_outputs(mapped, pairs)
    assert swept.n_luts == mapped.n_luts - 1
    words = input_patterns(4)
    np.testing.assert_array_equal(execute_packed(mapped, words),
                                  execute_packed(swept, words))


def test_no_false_duplicates():
    a = optimize(random_aig(11), rounds=1)
    mapped = map_aig(a)
    pairs, stats = find_duplicate_lut_outputs(mapped)
    assert (pairs, stats) == RC.find_duplicate_lut_outputs(to_ref(mapped))
    swept = merge_duplicate_lut_outputs(mapped, pairs)
    words = np.random.default_rng(0).integers(
        0, 1 << 32, (mapped.n_pis, 32), dtype=np.uint32)
    x, y = execute_packed(mapped, words), execute_packed(swept, words)
    for g, w in zip(x, y):
        np.testing.assert_array_equal(g, w)
