"""repro_torch.kernels.aig_sim and the device route of
repro_torch.synth.simulate against the reference on the same AIGs and
words, bit for bit: the public ``aig_sim`` route (k=2 LUTs through the
streamed lut_eval kernel), its tile plan, the one-node-per-step walk's
plain version, and ``simulate`` / ``random_equiv`` with
``use_kernel=True`` on the CPU."""
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
