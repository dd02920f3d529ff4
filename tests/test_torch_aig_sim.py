"""repro_torch.kernels.aig_sim and the device route of
repro_torch.synth.simulate against the reference on the same AIGs and
words, bit for bit: the public ``aig_sim`` route (k=2 LUTs through the
streamed lut_eval kernel), its tile plan, the walk's plain version
(also on AIGs at the walk kernel's edges, and its sizing), and
``simulate`` / ``random_equiv`` with ``use_kernel=True`` on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.aig_sim import aig_sim_ref as ref_walk
from repro.kernels.aig_sim.ops import compile_aig_tile_plan as ref_plan
from repro.synth import AIG as RefAIG
from repro.synth.from_sop import table_to_aig as ref_table_to_aig
from repro.synth.simulate import random_equiv as ref_random_equiv
from repro.synth.simulate import simulate as ref_simulate
from repro_torch import synth
from repro_torch.device import NoCudaDeviceError
from repro_torch.kernels.aig_sim import (aig_sim, aig_sim_ref, aig_sim_walk,
                                         compile_aig_tile_plan)
from repro_torch.kernels.aig_sim import ops as aig_ops
from repro_torch.kernels.spec import DEFAULT_SPEC
from repro_torch.synth.from_sop import table_to_aig
from repro_torch.synth.simulate import _simulate_np

PLAN_FIELDS = ("tt_tiles", "leaf_tiles", "leaf_loc", "gather_rows",
               "out_base", "level_of_tile", "out_idx", "out_neg",
               "row_of_wire")


def _aigs(seed, n_vars, n_outs):
    """The same random AIG built by both packages."""
    rng = np.random.default_rng(seed)
    tables = [rng.random(1 << n_vars) < 0.5 for _ in range(n_outs)]
    lits = [2 * (i + 1) for i in range(n_vars)]
    ours, ref = synth.AIG(n_vars), RefAIG(n_vars)
    ours.outputs = [table_to_aig(ours, t, None, lits) for t in tables]
    ref.outputs = [ref_table_to_aig(ref, t, None, lits) for t in tables]
    return ours, ref


@pytest.mark.parametrize("seed,n_vars,n_outs", [(0, 5, 2), (1, 7, 3),
                                                (2, 8, 1)])
@pytest.mark.parametrize("n_words", [1, 7, 33])
def test_simulate_kernel_route_matches_reference(seed, n_vars, n_outs,
                                                 n_words):
    ours, ref = _aigs(seed, n_vars, n_outs)
    f0, f1 = ours.fanin_arrays()
    rf0, rf1 = ref.fanin_arrays()
    np.testing.assert_array_equal(f0, rf0)
    np.testing.assert_array_equal(f1, rf1)
    words = synth.random_words(n_vars, n_words, seed=n_words)
    want = ref_simulate(ref, words, use_pallas=True)
    got = synth.simulate(ours, words, use_kernel=True, device="cpu")
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(synth.simulate(ours, words), want)
    plane = aig_sim(words, f0, f1, n_vars, device="cpu")
    np.testing.assert_array_equal(plane, _simulate_np(ours, words))


@pytest.mark.parametrize("seed,n_vars,n_outs", [(0, 5, 2), (3, 6, 4)])
@pytest.mark.parametrize("n_words", [1, 5])
def test_walk_plain_version_matches_reference_oracle(seed, n_vars, n_outs,
                                                     n_words):
    ours, _ = _aigs(seed, n_vars, n_outs)
    f0, f1 = ours.fanin_arrays()
    words = synth.random_words(n_vars, n_words, seed=seed).view(np.int32)
    want = np.asarray(ref_walk(jnp.asarray(words), jnp.asarray(f0),
                               jnp.asarray(f1), n_vars))
    got = aig_sim_walk(*map(torch.from_numpy, (words, f0, f1)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        aig_sim_ref(*map(torch.from_numpy, (words, f0, f1)), n_vars).numpy(),
        want)


@pytest.mark.parametrize("tile_rows", [8, 32])
def test_tile_plan_matches_reference(tile_rows):
    ours, _ = _aigs(4, 7, 3)
    f0, f1 = ours.fanin_arrays()
    got = compile_aig_tile_plan(f0, f1, 7, tile_rows)
    want = ref_plan(f0, f1, 7, tile_rows)
    for name in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    for name in ("n_pis", "n_rows", "tile_rows", "gather_cap", "k"):
        assert getattr(got, name) == getattr(want, name), name


def test_plan_is_cached_by_structure():
    ours, _ = _aigs(5, 5, 2)
    f0, f1 = ours.fanin_arrays()
    a = aig_ops._cached_plan(f0, f1, 5, 32)
    assert aig_ops._cached_plan(f0.copy(), f1.copy(), 5, 32) is a
    assert aig_ops._cached_plan(f0, f1, 5, 8) is not a


@pytest.mark.parametrize("flip", [False, True])
def test_random_equiv_kernel_route_matches_reference(flip):
    ours_a, ref_a = _aigs(6, 6, 2)
    ours_b, ref_b = _aigs(6, 6, 2)
    if flip:                      # complement one output of b
        ours_b.outputs[1] ^= 1
        ref_b.outputs[1] ^= 1
    want = ref_random_equiv(ref_a, ref_b, n_words=4, use_pallas=True)
    assert want is (not flip)
    assert synth.random_equiv(ours_a, ours_b, n_words=4, use_kernel=True,
                              device="cpu") is want
    assert synth.random_equiv(ours_a, ours_b, n_words=4) is want


def test_kernel_route_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    ours, _ = _aigs(0, 4, 1)
    words = synth.random_words(4, 2)
    with pytest.raises(NoCudaDeviceError):
        synth.simulate(ours, words, use_kernel=True)
    f0, f1 = ours.fanin_arrays()
    with pytest.raises(NoCudaDeviceError):
        aig_sim(words, f0, f1, 4)


def test_empty_and_input_only_planes():
    words = synth.random_words(3, 2)
    plane = aig_sim(words, np.zeros(0, np.int32), np.zeros(0, np.int32), 3,
                    device="cpu")
    np.testing.assert_array_equal(plane[1:], words)
    assert not plane[0].any()
    walk = aig_sim_walk(torch.from_numpy(words.view(np.int32)),
                        torch.zeros(0, dtype=torch.int32),
                        torch.zeros(0, dtype=torch.int32))
    np.testing.assert_array_equal(walk.numpy().view(np.uint32), plane)


def _random_dag(seed, n_pis, n_ands):
    """Each node reads two random literals of earlier rows (the constant
    and the inputs included)."""
    rng = np.random.default_rng(seed)
    hi = 2 * (1 + n_pis + np.arange(n_ands))
    return ((rng.random(n_ands) * hi).astype(np.int32),
            (rng.random(n_ands) * hi).astype(np.int32))


def _strict_chain(seed, n_pis, n_ands):
    """Node i ANDs node i - 1 (the last input for node 0) with a random
    earlier literal: depth n_ands, but values that settle early."""
    rng = np.random.default_rng(seed)
    prev = 2 * (n_pis + np.arange(n_ands)) + rng.integers(0, 2, n_ands)
    hi = 2 * (1 + n_pis + np.arange(n_ands))
    return prev.astype(np.int32), (rng.random(n_ands) * hi).astype(np.int32)


def _toggling_chain(seed, n_pis, n_ands):
    """Node i is NOT node i - 1 (the last input for node 0), ANDed with
    the constant 1: depth n_ands, and every sweep before the last
    changes a row."""
    del seed
    prev = 2 * (n_pis + np.arange(n_ands)) + 1
    return prev.astype(np.int32), np.ones(n_ands, np.int32)


def _two_level(seed, n_pis, n_ands):
    """A wide AIG of depth 2: the first half of the nodes AND two
    inputs, the second half two nodes of the first half."""
    rng = np.random.default_rng(seed)
    half = n_ands // 2
    lo = 2 * rng.integers(1, n_pis + 1, (2, half)) + rng.integers(0, 2,
                                                                  (2, half))
    hi = (2 * (1 + n_pis + rng.integers(0, half, (2, n_ands - half)))
          + rng.integers(0, 2, (2, n_ands - half)))
    f = np.concatenate([lo, hi], axis=1).astype(np.int32)
    return f[0], f[1]


@pytest.mark.parametrize("kind,n_pis,n_ands", [
    ("strict chain", 6, 120), ("toggling chain", 6, 120),
    ("random DAG", 9, 300), ("two levels", 12, 400)])
@pytest.mark.parametrize("n_words", [1, 3, 9])
def test_walk_matches_reference_oracle_at_kernel_edges(kind, n_pis, n_ands,
                                                       n_words):
    """The AIGs at the walk kernel's edges (depth equal to the node
    count, with values that settle early and with values that change
    until the last sweep, a random DAG, a wide AIG of depth 2) through
    the port's walk and the reference's ``lax.scan`` oracle, bit for
    bit."""
    make = {"strict chain": _strict_chain, "toggling chain": _toggling_chain,
            "random DAG": _random_dag, "two levels": _two_level}[kind]
    f0, f1 = make(n_words, n_pis, n_ands)
    words = synth.random_words(n_pis, n_words, seed=n_ands).view(np.int32)
    want = np.asarray(ref_walk(jnp.asarray(words), jnp.asarray(f0),
                               jnp.asarray(f1), n_pis))
    got = aig_sim_walk(*map(torch.from_numpy, (words, f0, f1)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_words", [1, 4])
def test_forward_literals_read_zero(n_words):
    """A literal of the node itself or of a later row reads that row as
    0 (then the complement), in the port's plain version as in the
    reference's oracle."""
    n_pis = 3
    first = 1 + n_pis
    # node 0: itself & input 1; node 1: ~itself & input 2; node 2: ~(a
    # later row) & node 0; node 3: itself & ~node 1
    f0 = np.array([2 * first, 2 * (first + 1) + 1, 2 * (first + 3) + 1,
                   2 * (first + 3)], np.int32)
    f1 = np.array([2, 4, 2 * first, 2 * (first + 1) + 1], np.int32)
    words = synth.random_words(n_pis, n_words, seed=2).view(np.int32)
    want = np.asarray(ref_walk(jnp.asarray(words), jnp.asarray(f0),
                               jnp.asarray(f1), n_pis))
    got = aig_sim_walk(*map(torch.from_numpy, (words, f0, f1))).numpy()
    np.testing.assert_array_equal(got, want)
    x = words.view(np.uint32)
    plane = got.view(np.uint32)
    np.testing.assert_array_equal(plane[first], 0)
    np.testing.assert_array_equal(plane[first + 1], x[1])
    np.testing.assert_array_equal(plane[first + 2], 0)
    np.testing.assert_array_equal(plane[first + 3], 0)
    f0r, f1r = _random_dag(7, n_pis, 50)
    f0r[::3] = 2 * np.minimum(first + np.arange(50)[::3] + 7,
                              first + 49) + 1         # forward reads
    np.testing.assert_array_equal(
        aig_sim_walk(*map(torch.from_numpy, (words, f0r, f1r))).numpy(),
        np.asarray(ref_walk(jnp.asarray(words), jnp.asarray(f0r),
                            jnp.asarray(f1r), n_pis)))


@pytest.mark.parametrize("n_pis,n_ands,w,plan", [
    (8, 601, 256, (2, True)),          # the bench AIG: 128 blocks
    (8, 601, 255, (2, True)),
    (8, 601, 254, (1, True)),          # 2 words would give 127
    (8, 601, 509, (4, True)),
    (8, 601, 1, (1, True)),
    (16, 60_000, 7, (1, False)),       # planes past 227 KB
    (16, 12_000, 1024, (1, True)),     # narrowed until it fits
])
def test_plan_walk_tiles_and_branches(n_pis, n_ands, w, plan):
    """The walk's word tile is the widest of 4 / 2 / 1 that still gives
    128 blocks, narrowed until the two planes and the staged literals
    fit the 227 KB shared-memory budget, else the planes are in device
    memory."""
    assert aig_ops.plan_walk(n_pis, n_ands, w) == plan
    tw, smem = plan
    assert smem == (aig_ops.walk_smem_bytes(n_pis, n_ands, tw)
                    <= DEFAULT_SPEC.tile.smem_budget_bytes)


def _depth(f0, f1, n_pis):
    lvl = np.zeros(1 + n_pis + len(f0), np.int64)
    for i, (a, b) in enumerate(zip(f0 >> 1, f1 >> 1)):
        row = 1 + n_pis + i
        lvl[row] = 1 + max(lvl[a] if a < row else 0, lvl[b] if b < row else 0)
    return int(lvl.max())


@pytest.mark.parametrize("seed", [0, 1])
def test_max_sweeps_leaves_shallow_aigs_to_the_sweeps(seed):
    """A bench-sized AIG (8 inputs, 4 random outputs, about 600 ANDs)
    ends its sweeps (depth + 2 at most) well inside the cap, and a
    toggling chain of 2,500 ANDs, which needs 2,500 sweeps, reaches it
    and finishes in node order; the cap grows with the node count."""
    rng = np.random.default_rng(seed)
    aig = synth.AIG(8)
    aig.outputs = [table_to_aig(aig, rng.random(256) < 0.5, None,
                                [2 * (i + 1) for i in range(8)])
                   for _ in range(4)]
    f0, f1 = aig.fanin_arrays()
    assert _depth(f0, f1, 8) + 2 <= aig_ops.max_sweeps(len(f0)) // 2
    f0, f1 = _toggling_chain(seed, 16, 2500)
    assert _depth(f0, f1, 16) == 2500 > aig_ops.max_sweeps(2500) == 172
    assert aig_ops.max_sweeps(60_000) > aig_ops.max_sweeps(2500)
