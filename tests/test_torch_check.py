"""repro_torch.check against repro.check: every pass flags the same
seeded corruption with the same findings, and stays silent on clean
artifacts, in both packages.

Each test ports one of the reference's ``tests/test_check.py`` (same
name): the same artifact (AIG / mapped netlist / DevicePlan / source
file) is built by each package from the same seed, corrupted
the same way, and checked by each package; the reports must agree in
``ok``, ``checked`` and every issue's pass, code, severity, location
and counterexample, and the port's must also meet the reference test's
own assertions. Where the packages differ by design it is said: the
plan check's footprint (the CUDA walks' shared memory here, TPU VMEM
there) and the concurrency lint's scan of the port's own serve/obs
files and tests, and the plan check's cache, which here keys on the
tile schedule's contents. The reference's three ``check_regression``
tests are twinned in test_torch_bench_run.py.
"""
import copy
import dataclasses
import textwrap
import types

import numpy as np
import pytest
import torch
from hyp_compat import given, settings, st

import repro.check as RC
import repro.synth as RS
import repro_torch.check as PC
import repro_torch.synth as PSY
from repro.check import concurrency as ref_conc
from repro.check import pipeline as ref_pipeline
from repro.synth.executor import execute_packed as ref_execute_packed
from repro.synth.lutmap import MappedLUT as RefMappedLUT
from repro.synth.simulate import input_patterns as ref_input_patterns
from repro.synth.simulate import pack_bits as ref_pack_bits
from repro.synth.simulate import simulate as ref_simulate
from repro_torch.check import concurrency as port_conc
from repro_torch.check import pipeline as port_pipeline
from repro_torch.check.plan_check import SERVE_WORDS
from repro_torch.kernels.lut_eval import plan_stacked, plan_streamed
from repro_torch.kernels.spec import DEFAULT_SPEC
from repro_torch.synth.executor import execute_packed
from repro_torch.synth.lutmap import MappedLUT
from repro_torch.synth.simulate import input_patterns, pack_bits, simulate

REF = types.SimpleNamespace(
    check=RC, synth=RS, MappedLUT=RefMappedLUT,
    execute_packed=ref_execute_packed, input_patterns=ref_input_patterns,
    pack_bits=ref_pack_bits, simulate=ref_simulate, conc=ref_conc,
    pipeline=ref_pipeline)
PORT = types.SimpleNamespace(
    check=PC, synth=PSY, MappedLUT=MappedLUT, execute_packed=execute_packed,
    input_patterns=input_patterns, pack_bits=pack_bits, simulate=simulate,
    conc=port_conc, pipeline=port_pipeline)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # the oracle's table gathers are tiny torch ops, slowest with a pool
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_aig(P, seed, n_pis=6, n_ands=30):
    rng = np.random.default_rng(seed)
    a = P.synth.AIG(n_pis)
    lits = [P.synth.lit(p + 1) for p in range(n_pis)]
    for _ in range(n_ands):
        i, j = rng.choice(len(lits), 2, replace=False)
        lits.append(a.and2(lits[i] ^ int(rng.integers(2)),
                           lits[j] ^ int(rng.integers(2))))
    outs = [l for l in lits[n_pis:] if P.synth.lit_var(l) != 0][-3:]
    a.outputs = outs or [lits[-1]]
    return a


def mapped_fn(P, mapped, n_pis):
    """Ground-truth output words of a mapped net on all 2^n inputs."""
    return P.execute_packed(mapped, P.input_patterns(n_pis))


def eval_on_bits(P, fn_words, bits):
    """Evaluate a packed evaluator on one explicit PI bit pattern."""
    words = P.pack_bits(np.asarray(bits, np.uint8)[:, None])
    return (np.asarray(fn_words(words))[:, 0] & 1).astype(int)


def summary(rep):
    """Everything two reports must share: verdict, count of checks and
    each issue's pass, code, severity, location and witness."""
    return (rep.ok, rep.checked,
            [(i.pass_name, i.code, i.severity, i.where,
              None if i.counterexample is None
              else dataclasses.astuple(i.counterexample))
             for i in rep.issues])


def both(scenario, *args):
    """Run ``scenario(P, *args)`` in each package; returns (ref, port)
    after asserting their reports' summaries are equal."""
    ref, port = scenario(REF, *args), scenario(PORT, *args)
    assert summary(port) == summary(ref)
    return ref, port


def _codes(rep):
    return {i.code for i in rep.errors}


# ---------------------------------------------------------------------------
# report plumbing
# ---------------------------------------------------------------------------

def test_report_merge_errors_and_require_ok():
    def scenario(P):
        r = P.check.CheckReport("a")
        r.warn("lint", "w", "just a warning")
        assert r.ok and len(r.warnings) == 1
        r2 = P.check.CheckReport("b")
        r2.error("equiv", "stage", "boom", where="lut 3")
        r.merge(r2)
        return r

    ref, port = both(scenario)
    assert not port.ok and port.errors[0].code == "stage"
    assert port.format() == ref.format() and "FAIL" in port.format()
    assert port.format(verbose=True) == ref.format(verbose=True)
    with pytest.raises(PC.CheckFailure) as ei:
        PC.require_ok(port)
    assert "boom" in str(ei.value) and ei.value.report is port


# ---------------------------------------------------------------------------
# pass 1: netlist lint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_lint_clean_on_unmutated(seed):
    def scenario(P):
        a = random_aig(P, seed)
        rep = P.check.lint_aig(a)
        opt = P.synth.optimize(a, rounds=1)
        rep.merge(P.check.lint_aig(opt))
        return rep.merge(P.check.lint_mapped(P.synth.map_aig(opt, k=4)))

    _, port = both(scenario)
    assert port.ok, port.format()


_AIG_MUTATIONS = ["level", "cycle", "operand-order", "duplicate-and",
                  "const-fanin", "bad-output"]


def _mutate_aig(P, code):
    a = random_aig(P, 1)
    n = a.n_nodes
    bad = copy.deepcopy(a)
    if code == "level":
        bad._level[n - 1] += 1                   # broken levelization
    elif code == "cycle":
        bad._f0[n - 1] = P.synth.lit(n - 1)      # self/forward reference
    elif code == "operand-order":
        f0, f1 = bad._f0[n - 1], bad._f1[n - 1]
        bad._f0[n - 1], bad._f1[n - 1] = f1, f0  # de-canonicalised operands
    elif code == "duplicate-and":
        bad._f0.append(bad._f0[n - 1])           # strash violation
        bad._f1.append(bad._f1[n - 1])
        bad._level.append(bad._level[n - 1])
    elif code == "const-fanin":
        bad._f0[n - 1] = P.synth.CONST1          # un-propagated constant
    else:
        bad.outputs[0] = P.synth.lit(n + 7)      # dangling output wire
    return P.check.lint_aig(bad)


def test_lint_aig_flags_structural_corruption():
    for code in _AIG_MUTATIONS:
        _, port = both(_mutate_aig, code)
        assert code in _codes(port)


def _mapped_mutations(P):
    m = P.synth.map_aig(P.synth.optimize(random_aig(P, 2), rounds=1), k=4)
    assert len(m.luts) >= 2, "need a multi-LUT net for these mutations"
    L = P.MappedLUT
    out = []
    bad = dataclasses.replace(m, luts=list(m.luts))
    l = bad.luts[-1]
    bad.luts[-1] = L(l.root, l.leaves, 1 << (1 << len(l.leaves)))
    out.append(("init-width", bad))              # INIT wider than 2^m
    bad = dataclasses.replace(m, luts=list(m.luts))
    l0, l1 = bad.luts[0], bad.luts[-1]
    bad.luts[0] = L(l0.root, (l1.root,) + l0.leaves[1:], l0.tt)
    out.append(("undefined-leaf", bad))          # reads a later wire
    bad = dataclasses.replace(m, luts=list(m.luts))
    l = bad.luts[-1]
    bad.luts[-1] = L(bad.luts[0].root, l.leaves, l.tt)
    out.append(("duplicate-root", bad))
    bad = dataclasses.replace(m, luts=list(m.luts))
    l = bad.luts[0]
    bad.luts[0] = L(l.root, tuple(range(1, m.k + 2)), 0)
    out.append(("fanin-width", bad))             # fanin > k
    # dropped LUT (a "level edge" removed): its root becomes undefined
    used_roots = {x for l in m.luts for x in l.leaves if x > m.n_pis}
    victim = next(i for i, l in enumerate(m.luts) if l.root in used_roots)
    out.append(("dropped", dataclasses.replace(
        m, luts=[l for i, l in enumerate(m.luts) if i != victim])))
    return out


def test_lint_mapped_flags_corruption():
    ref_muts, port_muts = _mapped_mutations(REF), _mapped_mutations(PORT)
    for (code, rbad), (_, pbad) in zip(ref_muts, port_muts):
        ref, port = REF.check.lint_mapped(rbad), PC.lint_mapped(pbad)
        assert summary(port) == summary(ref), code
        if code == "dropped":
            assert {"undefined-leaf", "undefined-output"} & _codes(port)
        else:
            assert code in _codes(port)


# ---------------------------------------------------------------------------
# pass 2: equivalence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_equiv_clean_pipeline(seed):
    def scenario(P):
        a = random_aig(P, seed)
        opt = P.synth.optimize(a, rounds=2)
        rep = P.check.equiv_aigs(a, opt)
        m = P.synth.map_aig(opt, k=4)
        rep.merge(P.check.equiv_aig_mapped(opt, m))
        return rep.merge(P.check.equiv_mapped_plan(
            m, P.synth.compile_device_plan(m)))

    _, port = both(scenario)
    assert port.ok, port.format()


def test_equiv_reports_valid_exhaustive_counterexample():
    def scenario(P):
        a = random_aig(P, 3)
        dut = copy.deepcopy(a)
        dut.outputs = [dut.outputs[0] ^ 1] + dut.outputs[1:]
        return P.check.equiv_aigs(a, dut)

    _, rep = both(scenario)
    a = random_aig(PORT, 3)
    dut = copy.deepcopy(a)
    dut.outputs = [dut.outputs[0] ^ 1] + dut.outputs[1:]
    assert not rep.ok
    cex = rep.errors[0].counterexample
    assert cex is not None and cex.exhaustive
    assert len(cex.inputs) == a.n_pis
    # the witness must actually separate the two networks
    got = eval_on_bits(PORT, lambda w: simulate(dut, w), cex.inputs)
    want = eval_on_bits(PORT, lambda w: simulate(a, w), cex.inputs)
    assert got[cex.output] == cex.got and want[cex.output] == cex.want
    assert cex.got != cex.want


def test_equiv_wide_cone_uses_sampled_vectors():
    def scenario(P, flip):
        a = random_aig(P, 4, n_pis=24, n_ands=60)   # > EXHAUSTIVE_LIMIT
        dut = copy.deepcopy(a)
        if flip:
            dut.outputs = [dut.outputs[0] ^ 1] + dut.outputs[1:]
        return P.check.equiv_aigs(a, dut)

    _, rep = both(scenario, True)
    assert not rep.ok
    assert rep.errors[0].counterexample is not None
    assert not rep.errors[0].counterexample.exhaustive
    _, clean = both(scenario, False)               # clean stays clean
    assert clean.ok


def test_equiv_interface_mismatch():
    def scenario(P):
        return P.check.equiv_aigs(random_aig(P, 0, n_pis=4),
                                  random_aig(P, 0, n_pis=5))

    _, port = both(scenario)
    assert "aig-rewrite" in _codes(port)


def _flip_init(P, seed, which, row):
    a = P.synth.optimize(random_aig(P, seed, n_pis=5, n_ands=25), rounds=1)
    m = P.synth.map_aig(a, k=4)
    if not m.luts:
        return None
    i = which % len(m.luts)
    l = m.luts[i]
    r = row % (1 << len(l.leaves))
    bad = dataclasses.replace(m, luts=list(m.luts))
    bad.luts[i] = P.MappedLUT(l.root, l.leaves, l.tt ^ (1 << r))
    changed = not np.array_equal(mapped_fn(P, m, a.n_pis),
                                 mapped_fn(P, bad, a.n_pis))
    return a, bad, changed, P.check.equiv_aig_mapped(a, bad)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10_000), which=st.integers(0, 3),
       row=st.integers(0, 63))
def test_mutation_flip_init_bit_killrate(seed, which, row):
    """Flip one INIT bit of one LUT: both packages' miters flag the
    corruption exactly when the function actually changed, with the
    same witness."""
    ref, port = _flip_init(REF, seed, which, row), \
        _flip_init(PORT, seed, which, row)
    if port is None:
        assert ref is None
        return
    a, bad, changed, rep = port
    assert summary(rep) == summary(ref[3]) and changed == ref[2]
    assert rep.ok == (not changed), rep.format()
    if changed:
        cex = rep.errors[0].counterexample
        got = eval_on_bits(PORT, lambda w: execute_packed(bad, w),
                           cex.inputs)
        want = eval_on_bits(PORT, lambda w: simulate(a, w), cex.inputs)
        assert got[cex.output] != want[cex.output]


def _swap_leaves(P, seed, which):
    a = P.synth.optimize(random_aig(P, seed, n_pis=5, n_ands=25), rounds=1)
    m = P.synth.map_aig(a, k=4)
    multi = [i for i, l in enumerate(m.luts) if len(l.leaves) >= 2]
    if not multi:
        return None
    i = multi[which % len(multi)]
    l = m.luts[i]
    leaves = list(l.leaves)
    leaves[0], leaves[1] = leaves[1], leaves[0]
    bad = dataclasses.replace(m, luts=list(m.luts))
    bad.luts[i] = P.MappedLUT(l.root, tuple(leaves), l.tt)
    changed = not np.array_equal(mapped_fn(P, m, a.n_pis),
                                 mapped_fn(P, bad, a.n_pis))
    return changed, P.check.equiv_aig_mapped(a, bad)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10_000), which=st.integers(0, 3))
def test_mutation_swap_leaves_killrate(seed, which):
    """Swap two leaf wires of one LUT (same guard: symmetric truth
    tables make some swaps function-preserving)."""
    ref, port = _swap_leaves(REF, seed, which), \
        _swap_leaves(PORT, seed, which)
    if port is None:
        assert ref is None
        return
    changed, rep = port
    assert summary(rep) == summary(ref[1]) and changed == ref[0]
    assert rep.ok == (not changed), rep.format()


def _kill_rate(P, seed):
    a = P.synth.optimize(random_aig(P, seed, n_pis=5, n_ands=25), rounds=1)
    m = P.synth.map_aig(a, k=4)
    ref = mapped_fn(P, m, a.n_pis)
    out = []
    for i, l in enumerate(m.luts):
        muts = [P.MappedLUT(l.root, l.leaves, l.tt ^ 1)]
        if len(l.leaves) >= 2:
            lv = list(l.leaves)
            lv[0], lv[1] = lv[1], lv[0]
            muts.append(P.MappedLUT(l.root, tuple(lv), l.tt))
        for mut in muts:
            bad = dataclasses.replace(m, luts=list(m.luts))
            bad.luts[i] = mut
            changed = not np.array_equal(ref, mapped_fn(P, bad, a.n_pis))
            rep = P.check.equiv_aig_mapped(a, bad)
            out.append((changed, summary(rep)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_mutation_killrate_deterministic(seed):
    """Every LUT of every net gets one INIT-bit flip and one leaf swap:
    the port kills exactly the mutations that change the function, and
    kills the same ones as the reference with the same witnesses."""
    ref, port = _kill_rate(REF, seed), _kill_rate(PORT, seed)
    assert port == ref and port
    for changed, (ok, _, _) in port:
        assert ok == (not changed)


def test_constant_output_network():
    """Constant nets (zero LUTs, outputs on the const wire) pass every
    pass clean in both packages, the const-vs-const miter included."""
    def scenario(P):
        a = P.synth.AIG(3)
        a.outputs = [P.synth.CONST0, P.synth.CONST1, P.synth.lit(1)]
        m = P.synth.map_aig(a, k=4)
        assert m.n_luts == 0
        rep = P.check.lint_mapped(m)
        rep.merge(P.check.equiv_aig_mapped(a, m))
        dp = P.synth.compile_device_plan(m)
        rep.merge(P.check.validate_device_plan(dp, use_cache=False))
        rep.merge(P.check.equiv_mapped_plan(m, dp))
        z = P.synth.AIG(0)                       # zero-PI network
        z.outputs = [P.synth.CONST1]
        return rep.merge(P.check.equiv_aig_mapped(
            z, P.synth.map_aig(z, k=4)))

    _, port = both(scenario)
    assert port.ok, port.format()


# ---------------------------------------------------------------------------
# pass 3: device-plan validation
# ---------------------------------------------------------------------------

def _plan(P, seed=5, k=4):
    a = P.synth.optimize(random_aig(P, seed, n_pis=6, n_ands=40), rounds=1)
    m = P.synth.map_aig(a, k=k)
    return m, P.synth.compile_device_plan(m)


def _fresh(P, dp, **kw):
    return P.check.validate_device_plan(dp, use_cache=False, **kw)


def test_plan_clean_and_cached():
    m, dp = _plan(PORT)
    _, rdp = _plan(REF)
    rep = PC.validate_device_plan(dp)
    assert rep.ok and rep.info["smem_bytes"] > 0
    assert summary(rep) == summary(RC.validate_device_plan(rdp))
    assert PC.validate_device_plan(dp) is rep       # cache hit by hash
    assert PC.validate_device_plan(dp, use_cache=False) is not rep
    dp2 = PSY.compile_device_plan(m)
    # the same plan hashes alike here and in the reference package
    assert PC.plan_fingerprint(dp) == PC.plan_fingerprint(dp2) \
        == RC.plan_fingerprint(rdp)
    dp2.tt_bits[0, 0, 0] ^= 0xFFFFFFFF
    rdp.tt_bits[0, 0, 0] ^= 0xFFFFFFFF
    assert PC.plan_fingerprint(dp) != PC.plan_fingerprint(dp2) \
        == RC.plan_fingerprint(rdp)


def _corrupt_tiles(P):
    """A plan with tiles, validated clean (cache on), and a deep copy
    whose last tile reads its own output band."""
    m, _ = _plan(P)
    dp = P.synth.compile_device_plan(m, tile_rows=4)
    clean = P.check.validate_device_plan(dp)
    bad = copy.deepcopy(dp)
    last = bad.tiles.n_tiles - 1
    bad.tiles.leaf_tiles[last, 0, 0] = bad.tiles.out_base[last]
    return clean, bad


def test_plan_cache_sees_a_corrupted_tile_schedule():
    """The cache keys on the tile schedule's contents: a corrupted copy
    of a plan validated before is refused with the cache on, as it is
    with the cache off. The reference keys on (tile_rows, gather_cap)
    and hands back the clean report (a logged deviation)."""
    clean, bad = _corrupt_tiles(PORT)
    assert clean.ok, clean.format()
    assert PC.plan_fingerprint(bad) == PC.plan_fingerprint(
        PSY.compile_device_plan(_plan(PORT)[0], tile_rows=4))
    cached = PC.validate_device_plan(bad)
    assert not cached.ok and "tile-gather" in _codes(cached)
    assert summary(cached) == summary(_fresh(PORT, bad))
    assert {"tile-gather", "tile-order"} <= _codes(cached)
    ref_clean, ref_bad = _corrupt_tiles(REF)
    assert RC.validate_device_plan(ref_bad) is ref_clean
    assert summary(_fresh(REF, ref_bad)) == summary(cached)


def _plan_corruptions(P):
    _, dp = _plan(P)
    out = []
    bad = copy.deepcopy(dp)
    bad.leaf_idx[0, 0, 0] = bad.n_wires             # reads the dump row
    out.append(("leaf-range", _fresh(P, bad)))
    bad = copy.deepcopy(dp)
    bad.tt_bits[0, 0, 0] = 5                        # not a bitplane mask
    out.append(("tt-encoding", _fresh(P, bad)))
    bad = copy.deepcopy(dp)
    real = np.argwhere(bad.out_wires != bad.n_wires)
    (l0, s0), (l1, s1) = real[0], real[-1]
    bad.out_wires[l1, s1] = bad.out_wires[l0, s0]   # wire written twice
    out.append(("wire-cover", _fresh(P, bad)))
    bad = copy.deepcopy(dp)
    bad.out_idx[0] = bad.n_wires + 3
    out.append(("out-idx", _fresh(P, bad)))
    bad = dataclasses.replace(dp, leaf_idx=dp.leaf_idx.astype(np.int64))
    out.append(("dtype", _fresh(P, bad)))
    bad = copy.deepcopy(dp)
    bad.out_wires[0, 0] = bad.n_wires + 5           # out of range
    out.append(("out-range", _fresh(P, bad)))
    return out


def test_plan_corruptions_caught():
    for (code, ref), (_, port) in zip(_plan_corruptions(REF),
                                      _plan_corruptions(PORT)):
        assert summary(port) == summary(ref), code
        assert code in _codes(port)
    # the footprint differs by design: TPU VMEM there, here a budget
    # too small for one slot of the monolithic walk is what its wrapper
    # refuses
    _, dp = _plan(PORT)
    rep = _fresh(PORT, dp, smem_budget_bytes=1)
    assert _codes(rep) == {"smem-budget"}
    assert "vmem-budget" in _codes(_fresh(REF, _plan(REF)[1],
                                          vmem_budget_bytes=1))


def _pad_and_level(P):
    _, dp = _plan(P)
    out = []
    pads = np.argwhere(dp.out_wires == dp.n_wires)
    if pads.size:                                   # ragged level widths
        l, s = pads[0]
        bad = copy.deepcopy(dp)
        bad.tt_bits[l, s, 0] = 0xFFFFFFFF           # pad slot would write
        out.append(("pad-slot", _fresh(P, bad)))
        bad = copy.deepcopy(dp)
        bad.leaf_idx[l, s, 0] = 2                   # pad slot reads a wire
        out.append(("pad-slot", _fresh(P, bad)))
    # same-level read: point a slot's leaf at a wire its own level writes
    for l in range(dp.n_levels):
        real = np.nonzero(dp.out_wires[l] != dp.n_wires)[0]
        if len(real) >= 2:
            bad = copy.deepcopy(dp)
            bad.leaf_idx[l, real[0], 0] = bad.out_wires[l, real[1]]
            out.append(("level-order", _fresh(P, bad)))
            break
    return out


def test_plan_pad_slot_and_level_order():
    ref, port = _pad_and_level(REF), _pad_and_level(PORT)
    assert len(port) == len(ref) >= 1
    for (code, r), (_, p) in zip(ref, port):
        assert summary(p) == summary(r), code
        assert code in _codes(p)


def test_execute_plan_host_is_independent_reference():
    for seed in range(3):
        m, dp = _plan(PORT, seed)
        _, rdp = _plan(REF, seed)
        words = input_patterns(6)
        got = PC.execute_plan_host(dp, words)
        np.testing.assert_array_equal(got, execute_packed(m, words))
        np.testing.assert_array_equal(got, RC.execute_plan_host(rdp, words))


@pytest.mark.parametrize("tile_rows", [4, 32])
def test_plan_footprint_reports_the_walks_branch(tile_rows):
    """The port's footprint: each walk's launch at the serving batch's
    words, as its wrapper computes it (``plan_stacked`` /
    ``plan_streamed``); a plane too large for the budget moves to device
    memory without an error; only a plan unit the wrapper refuses is
    one."""
    m, _ = _plan(PORT)
    dp = PSY.compile_device_plan(m, tile_rows=tile_rows)
    tp = dp.tiles
    rep = _fresh(PORT, dp)
    assert rep.ok, rep.format()
    n_levels, lw, k = dp.leaf_idx.shape
    want = plan_stacked(dp.n_wires + 1, SERVE_WORDS, n_levels, lw, k,
                        DEFAULT_SPEC)
    got = rep.info["lut_eval"]
    assert (got["block_w"], got["plane"] == "shared", got["chunk"]) == want
    want = plan_streamed(tp.n_rows, SERVE_WORDS, tp.n_levels, tp.n_tiles,
                         tile_rows, k, DEFAULT_SPEC)
    got = rep.info["lut_eval_streamed"]
    assert (got["block_w"], got["plane"] == "shared", got["chunk"]) == want
    assert got["plane"] == "shared" and got["plan"] == "staged"
    assert rep.info["smem_bytes"] == got["smem_bytes"] > 0
    # every budget down to one that refuses the plan: the check gives
    # the wrapper's launch within the budget, and where not one plane
    # column fits beside the plan, the plane in device memory, no error
    seen = set()
    for budget in range(got["smem_bytes"], 0, -16):
        small = _fresh(PORT, dp, smem_budget_bytes=budget)
        if not small.ok:
            assert _codes(small) == {"smem-budget"}
            seen.add("refused")
            break
        b = small.info["lut_eval_streamed"]
        spec = DEFAULT_SPEC.with_tile(smem_budget_bytes=budget)
        assert (b["block_w"], b["plane"] == "shared", b["chunk"]) == \
            plan_streamed(tp.n_rows, SERVE_WORDS, tp.n_levels, tp.n_tiles,
                          tile_rows, k, spec)
        assert b["smem_bytes"] <= budget
        seen.add(b["plane"])
    assert seen == {"shared", "device", "refused"}
    # too small for one tile: the streamed walk's wrapper refuses it
    tiny = _fresh(PORT, dp, smem_budget_bytes=64)
    assert {(i.code, i.where) for i in tiny.errors} == {
        ("smem-budget", "lut_eval"), ("smem-budget", "lut_eval_streamed")}


# ---------------------------------------------------------------------------
# pass 4: concurrency lint
# ---------------------------------------------------------------------------

_VIOLATING = textwrap.dedent('''
    import threading

    class S:
        _GUARDED_BY = {"_stopping": "_cond"}
        _LOCKED_METHODS = ("_flush_locked",)

        def __init__(self):
            self._cond = threading.Condition()
            self._stopping = False      # __init__ is exempt

        def start(self):
            self._stopping = False      # BUG: write outside the lock

        def loop(self):
            with self._cond:
                ok = self._stopping     # fine
            return self.poll(self._stopping)    # BUG: read outside

        def callback_leak(self):
            with self._cond:
                return lambda: self._stopping   # BUG: runs lock-free later

        def bad_call(self):
            self._flush_locked()        # BUG: requires the lock held

        def _flush_locked(self):
            return self._stopping       # exempt via _LOCKED_METHODS
''')

_CLEAN = textwrap.dedent('''
    import threading

    class S:
        _GUARDED_BY = {"_stopping": "_cond"}
        _LOCKED_METHODS = ("_flush_locked",)

        def __init__(self):
            self._cond = threading.Condition()
            self._stopping = False

        def start(self):
            with self._cond:
                self._stopping = False
                if self._stopping:
                    self._flush_locked()

        def _flush_locked(self):
            return self._stopping
''')


def _lint_files(tmp_path, text):
    p = tmp_path / "mod.py"
    p.write_text(text)
    return both(lambda P: P.check.check_concurrency(files=[p]))[1]


def test_concurrency_lint_flags_violations(tmp_path):
    rep = _lint_files(tmp_path, _VIOLATING)
    codes = [(i.code, i.where) for i in rep.errors]
    assert sum(c == "unlocked-access" for c, _ in codes) == 3
    assert sum(c == "unlocked-call" for c, _ in codes) == 1
    lines = {int(w.split(":")[1]) for _, w in codes}
    assert len(lines) == 4              # four distinct source lines


def test_concurrency_lint_silent_on_clean(tmp_path):
    rep = _lint_files(tmp_path, _CLEAN)
    assert rep.ok, rep.format()
    assert rep.checked > 0              # it actually looked


def test_reject_reason_coverage(tmp_path):
    serve = tmp_path / "serve"
    tests = tmp_path / "tests"
    serve.mkdir(), tests.mkdir()
    (serve / "sched.py").write_text(textwrap.dedent('''
        class RejectReason:
            QUEUE_FULL = "queue_full"
            GHOST = "ghost"
        def submit():
            raise RuntimeError(RejectReason.QUEUE_FULL)
    '''))
    # named as the port's tests are, so both packages' scans read it
    (tests / "test_torch_s.py").write_text(
        "def test_full():\n    assert 'queue_full'\n")

    def scenario(P):
        rep = P.check.CheckReport("rr")
        P.conc.check_reject_coverage(serve, tests, rep)
        return rep

    _, rep = both(scenario)
    codes = {(i.code, i.where) for i in rep.errors}
    assert ("unraisable-reason", "GHOST") in codes    # no code path
    assert ("untested-reason", "GHOST") in codes      # no test
    assert not any(w == "QUEUE_FULL" for _, w in codes)
    # a file outside the port's test names is not read by the port
    (tests / "test_torch_s.py").rename(tests / "test_s.py")
    rep = PC.CheckReport("rr")
    port_conc.check_reject_coverage(serve, tests, rep)
    assert ("untested-reason", "QUEUE_FULL") in \
        {(i.code, i.where) for i in rep.errors}


def test_real_serve_stack_is_clean():
    """The port's own serve/obs files and tests/test_torch_*.py: every
    reject reason raised and named by a port test, every annotated
    field guarded (the same classes as the reference's)."""
    rep = PC.check_concurrency()
    assert rep.ok, rep.format()
    assert "MicroBatchScheduler" in rep.info["guarded_classes"]
    assert rep.checked > 10
    assert port_conc.SERVE_DIR.parts[-2:] == ("repro_torch", "serve")
    ref = RC.check_concurrency()
    assert sorted(rep.info["guarded_classes"]) == \
        sorted(ref.info["guarded_classes"])
    assert rep.info["reject_reasons"] == ref.info["reject_reasons"]


def test_obs_classes_are_linted():
    """The lint covers repro_torch.obs: the shared-mutable window /
    burn-rate / profiler classes carry (and satisfy) lock annotations."""
    rep = PC.check_concurrency()
    assert rep.ok, rep.format()
    for cls in ("WindowedMetrics", "BurnRateMonitor", "OnlineProfiler",
                "BucketRing"):
        assert cls in rep.info["guarded_classes"], cls


def test_lock_free_annotation_exempts_field(tmp_path):
    rep = _lint_files(tmp_path, textwrap.dedent('''
        import threading

        class S:
            _GUARDED_BY = {"_q": "_lock"}
            _LOCK_FREE = ("_hwm",)

            def __init__(self):
                self._lock = threading.Lock()
                self._q = []
                self._hwm = 0.0

            def push(self, t):
                self._hwm = max(self._hwm, t)   # declared benign race
                with self._lock:
                    self._q.append(t)
    '''))
    assert rep.ok, rep.format()


def test_conflicting_annotation_rejected(tmp_path):
    rep = _lint_files(tmp_path, textwrap.dedent('''
        import threading

        class S:
            _GUARDED_BY = {"_q": "_lock"}
            _LOCK_FREE = ("_q",)            # BUG: both annotations

            def __init__(self):
                self._lock = threading.Lock()
                self._q = []
    '''))
    assert any(i.code == "conflicting-annotation" for i in rep.errors)


# ---------------------------------------------------------------------------
# srclint + satellites
# ---------------------------------------------------------------------------

def test_srclint_flags_duplicate_definition(tmp_path):
    src = tmp_path / "pkg"
    src.mkdir()
    (src / "a.py").write_text("LUT_K = 6\n")
    (src / "b.py").write_text("LUT_K = 4\n")
    _, rep = both(lambda P: P.check.check_duplicate_definitions(
        src_dir=src))
    assert "duplicate-definition" in _codes(rep)
    real = PC.check_duplicate_definitions()      # the port's own tree
    assert real.ok and real.checked == len(real.info["watchlist"])


def test_lut_cost_single_source():
    """Both mappers of the port report through core.lutcost."""
    from repro_torch.core import lutcost, lutmap
    from repro_torch.synth import lutmap as synth_lutmap
    assert lutmap.MapReport is lutcost.MapReport
    assert synth_lutmap.LUT_K is lutcost.LUT_K
    assert lutmap.logicnets_lut_cost is lutcost.logicnets_lut_cost
    m = PSY.map_aig(random_aig(PORT, 0), k=4)
    r = m.report(ffs=7)
    assert (r.luts, r.depth, r.ffs) == (m.n_luts, m.depth, 7)
    assert r.fmax_mhz > 0
    rr = RS.map_aig(random_aig(REF, 0), k=4).report(ffs=7)
    assert dataclasses.astuple(r) == dataclasses.astuple(rr)


# ---------------------------------------------------------------------------
# verify= hooks
# ---------------------------------------------------------------------------

def _broken_plan_failure(P):
    a = random_aig(P, 6)
    m = P.synth.synthesize(a, effort=1, verify=True)   # should not raise
    dp = P.synth.compile_device_plan(m, verify=True)
    bad = copy.deepcopy(dp)
    bad.tt_bits[bad.tt_bits != 0] ^= 0xFFFFFFFF        # break every LUT
    with pytest.raises(P.check.CheckFailure) as ei:
        P.pipeline.verify_plan(m, bad)
    return ei.value.report


def test_verify_flag_passes_clean_and_raises_on_corruption():
    ref, port = _broken_plan_failure(REF), _broken_plan_failure(PORT)
    assert summary(port) == summary(ref)
    assert not port.ok


# ---------------------------------------------------------------------------
# LogicNetwork-level checks (SOP stage + valid-code oracle)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_nets():
    """(reference, port) LogicNetworks of the same one-layer tables."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import fcp
    from repro.core.logic_infer import LogicNetwork as RefLogicNetwork
    from repro.core.quant import ActQuantSpec as RefSpec
    from repro.core.truthtable import extract_layer_tables as ref_extract
    from repro_torch.core.logic_infer import LogicNetwork
    from repro_torch.core.quant import ActQuantSpec
    from repro_torch.core.truthtable import extract_layer_tables

    rng = np.random.default_rng(7)
    alpha = 2.0
    n_in, n_out, fanin = 6, 4, 3
    w = rng.normal(size=(n_out, n_in)).astype(np.float32)
    b = (rng.normal(size=(n_out,)) * 0.1).astype(np.float32)
    mask = np.asarray(fcp.topk_row_mask(jnp.asarray(w), fanin))
    rspec, pspec = RefSpec("sign", 1), ActQuantSpec("sign", 1)
    rlt = ref_extract(jnp.asarray(w), jnp.asarray(b), mask, rspec, rspec,
                      alpha, alpha, fanin)
    plt = extract_layer_tables(w, b, mask, pspec, pspec, alpha, alpha,
                               fanin)
    np.testing.assert_array_equal(plt.tables, np.asarray(rlt.tables))
    return (RefLogicNetwork([rlt], rspec, alpha, n_in, n_out),
            LogicNetwork([plt], pspec, alpha, n_in, n_out))


def test_full_pipeline_check_on_logic_network(tiny_nets):
    ref_net, net = tiny_nets
    rep = PC.check_synth_pipeline(net=net, fast=True)
    assert rep.ok, rep.format()
    assert rep.checked > 100
    assert summary(rep) == summary(RC.check_synth_pipeline(net=ref_net,
                                                           fast=True))
    assert (rep.info["n_luts"], rep.info["depth"]) > (0, 0)


def test_network_oracle_catches_mapped_corruption(tiny_nets):
    from repro_torch.synth.executor import BitplaneNetwork

    def scenario(P, net):
        m = P.synth.synthesize(P.synth.network_to_aig(net), effort=1)
        clean = P.check.equiv_network_mapped(net, m, n_samples=128)
        assert clean.ok, clean.format()
        bad = dataclasses.replace(m, outputs=[m.outputs[0] ^ 1]
                                  + m.outputs[1:])
        return bad, P.check.equiv_network_mapped(net, bad, n_samples=128)

    (_, ref), (bad, rep) = scenario(REF, tiny_nets[0]), \
        scenario(PORT, tiny_nets[1])
    assert summary(rep) == summary(ref)
    assert not rep.ok
    cex = rep.errors[0].counterexample
    assert cex is not None
    # the counterexample is an input *code* row; replaying it through
    # the oracle and the netlist must reproduce the disagreement
    net = tiny_nets[1]
    codes = np.asarray(cex.inputs)[None, :]
    want = net.apply_codes(torch.from_numpy(codes)).numpy()[0]
    got = BitplaneNetwork(net, bad, device="cpu").apply_codes(codes)[0]
    assert got[cex.output] != want[cex.output]


def test_preflight_on_bitplane_network(tiny_nets):
    """The port's preflight checks the plan its executors launch (the
    network's own levelized plan, with the streamed executor's tiles):
    the reference's findings plus the tile-schedule checks."""
    ref_net, net = tiny_nets
    bn = PSY.compile_logic_network(net, verify=True, device="cpu")
    rep = PC.preflight(bn, n_samples=64)
    assert rep.ok, rep.format()
    assert {"lut_eval", "lut_eval_streamed"} <= set(rep.info)
    rbn = RS.compile_logic_network(ref_net, verify=True)
    ref = RC.preflight(rbn, n_samples=64)
    assert [(i.pass_name, i.code) for i in rep.issues] == \
        [(i.pass_name, i.code) for i in ref.issues]
    assert rep.checked == ref.checked + 2        # tile-gather, tile-order


# ---------------------------------------------------------------------------
# the port's verify= hooks on corrupted artifacts (launch nothing)
# ---------------------------------------------------------------------------

def corrupt_served_plan(mp):
    """Give every BitplaneNetwork built under ``mp`` a levelized plan
    (the one its executors launch) whose first INIT word is neither 0
    nor ~0; the mapped netlist itself stays right."""
    from repro_torch.synth import executor
    real_init = executor.BitplaneNetwork.__init__

    def init(self, *args, **kw):
        real_init(self, *args, **kw)
        self._plan.levels[0].tt_bits[0, 0] = 5

    mp.setattr(executor.BitplaneNetwork, "__init__", init)


def test_verify_hooks_raise_on_corruption(tiny_nets, monkeypatch):
    """Each verify= entry point raises CheckFailure on a corrupted
    artifact: synthesize on a wrong mapping, compile_device_plan on a
    plan whose leaf reads the dump row, compile_logic_network and
    BitplaneNetwork.from_logic_network on a levelized plan with a bad
    INIT word."""
    from repro_torch import synth as synth_pkg
    from repro_torch.kernels import launch_counts
    from repro_torch.synth import executor

    net = tiny_nets[1]
    before = launch_counts()
    real_map = synth_pkg.map_aig

    def wrong_map(aig, k=6):
        m = real_map(aig, k=k)
        l = m.luts[-1]
        m.luts[-1] = MappedLUT(l.root, l.leaves,
                               l.tt ^ ((1 << (1 << len(l.leaves))) - 1))
        return m

    a = random_aig(PORT, 6)
    with monkeypatch.context() as mp:
        mp.setattr(synth_pkg, "map_aig", wrong_map)
        with pytest.raises(PC.CheckFailure) as ei:
            PSY.synthesize(a, verify=True)
        assert "aig-mapped" in {i.code for i in ei.value.report.errors}

    m = PSY.synthesize(a)
    plan = executor._compile_plan(m)
    plan.levels[0].leaf_idx[0, 0] = 1 + m.n_pis + m.n_luts   # dump row
    with pytest.raises(PC.CheckFailure) as ei:
        PSY.compile_device_plan(m, plan, verify=True)
    assert "leaf-range" in _codes(ei.value.report)
    # an output wire past the plane: CheckFailure, where the reference's
    # verify_plan runs its host miter over the plan and raises IndexError
    plan = executor._compile_plan(m)
    plan.levels[-1].out_wires[0] = 1 + m.n_pis + m.n_luts + 5
    with pytest.raises(PC.CheckFailure) as ei:
        PSY.compile_device_plan(m, plan, verify=True)
    assert _codes(ei.value.report) == {"out-range"}

    with monkeypatch.context() as mp:
        corrupt_served_plan(mp)
        for build in (lambda: PSY.compile_logic_network(
                          net, verify=True, device="cpu"),
                      lambda: executor.BitplaneNetwork.from_logic_network(
                          net, verify=True, engine="cuda", device="cpu")):
            with pytest.raises(PC.CheckFailure) as ei:
                build()
            assert "tt-encoding" in _codes(ei.value.report)
    assert launch_counts() == before


# ---------------------------------------------------------------------------
# the trace pass and the CLI
# ---------------------------------------------------------------------------

def test_trace_pass_matches_reference():
    """The port's trace check on the port's live FakeClock scheduler
    trace, and on the reference's, gives the reference checker's
    findings (the port's traces stay checked by both)."""
    for pkg in (PC, RC):
        events, dropped = pkg.synthetic_trace_events()
        port = PC.check_trace(events, n_dropped=dropped)
        assert summary(port) == summary(RC.check_trace(events,
                                                       n_dropped=dropped))
        assert port.ok and port.checked > 0, port.format()
    from repro_torch.check.tracecheck import check_phase_reconciliation
    events, dropped = PC.synthetic_trace_events()
    rep = check_phase_reconciliation(events, n_dropped=dropped)
    assert rep.ok and rep.info["phase_recon"]["n_checked"] > 0


@pytest.mark.parametrize("argv", [["--static"],
                                  ["--passes", "trace,concurrency,srclint"],
                                  ["--fast", "-v"]])
def test_check_cli_passes_on_the_cpu(argv, capsys):
    from repro_torch.check.__main__ import main
    assert main(["--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out
    assert "[check] PASS" in out
    if "--fast" in argv:
        assert "UNPROVEN=0" in out and " SAT=0" in out
        assert "[check] synth-pipeline: OK" in out
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--passes", "lint,bogus"])


# ---------------------------------------------------------------------------
# the launcher's --check
# ---------------------------------------------------------------------------

def test_launcher_check_preflights_then_serves(capsys):
    from repro_torch.launch.serve import main
    out = main(["--mode", "logic", "--backend", "bitplane", "--device",
                "cpu", "--train-steps", "20", "--check", "--requests", "2"])
    text = capsys.readouterr().out
    assert out["preflight"].ok
    assert "[check] preflight: OK" in text
    assert "lut_eval_streamed: plane in shared memory" in text
    assert out["labels"].shape == (128,)
    assert "[serve] 2 requests" in text


def test_launcher_check_refuses_a_corrupted_plan(monkeypatch, capsys):
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import main
    corrupt_served_plan(monkeypatch)
    before = launch_counts()
    with pytest.raises(SystemExit) as ei:
        main(["--mode", "logic", "--backend", "bitplane", "--engine",
              "cuda", "--device", "cpu", "--train-steps", "0", "--check"])
    assert ei.value.code == 2
    text = capsys.readouterr().out
    assert "[check] preflight: FAIL" in text and "tt-encoding" in text
    assert "[serve] 8 requests" not in text
    assert launch_counts() == before


def test_launcher_check_has_nothing_to_verify_off_bitplane(capsys):
    from repro_torch.launch.serve import main
    out = main(["--mode", "logic", "--backend", "gather", "--device", "cpu",
                "--train-steps", "0", "--check", "--requests", "1"])
    assert "preflight" not in out
    assert "--check: nothing to verify for backend 'gather'" in \
        capsys.readouterr().out
