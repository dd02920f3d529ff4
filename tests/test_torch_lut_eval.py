"""repro_torch.kernels.lut_eval against the reference: the monolithic
and streamed walks (plain torch versions on the CPU) give bit-identical
wire planes to ``repro``'s jnp scan oracle, its streamed Pallas kernel
in interpret mode ("fancy" gather) and its numpy fold. The CUDA kernels
are held against the same plain versions on the card in
test_torch_gpu.py."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.synth as ref_synth
from repro.kernels.lut_eval import lut_eval_ref as ref_lut_eval_ref
from repro.kernels.lut_eval import lut_eval_streamed as ref_lut_eval_streamed
from repro.synth.executor import _compile_plan as ref_compile_plan
from repro_torch import synth
from repro_torch.kernels.lut_eval import (level_starts, lut_eval,
                                          lut_eval_streamed, plan_block,
                                          plan_stacked, plan_streamed,
                                          stacked_smem_bytes,
                                          streamed_smem_bytes)
from repro_torch.kernels.spec import DEFAULT_SPEC
from repro_torch.synth.executor import _compile_plan
from repro_torch.synth.from_sop import table_to_aig


@functools.lru_cache(maxsize=None)
def _mapped(seed, n_vars, n_outs):
    """A random mapped netlist from the port's synthesis, and the same
    netlist as the reference package's ``MappedNetwork``."""
    rng = np.random.default_rng(seed)
    aig = synth.AIG(n_vars)
    aig.outputs = [table_to_aig(aig, rng.random(1 << n_vars) < 0.5, None,
                                [2 * (i + 1) for i in range(n_vars)])
                   for _ in range(n_outs)]
    return _both(synth.synthesize(aig))


def _both(mapped):
    ref = ref_synth.MappedNetwork(
        mapped.n_pis, mapped.k,
        [ref_synth.MappedLUT(l.root, l.leaves, l.tt) for l in mapped.luts],
        list(mapped.outputs))
    return mapped, ref


def _constant():
    aig = synth.AIG(3)
    aig.outputs = [1]                    # const-1 literal
    return _both(synth.synthesize(aig))


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _dplan_tensors(dp, device="cpu"):
    return [_i32(a).to(device) for a in (dp.leaf_idx, dp.tt_bits,
                                         dp.out_wires)]


def _tplan_tensors(tp, device="cpu"):
    return [_i32(a).to(device) for a in (
        tp.tt_tiles, tp.leaf_tiles, tp.out_base,
        level_starts(tp.level_of_tile))]


def _outputs(plane_u32, out_idx, out_neg):
    out = plane_u32[out_idx]
    out[out_neg] = ~out[out_neg]
    return out


@pytest.mark.parametrize("n_words", [1, 7, 130])
def test_monolithic_plain_matches_reference(n_words):
    mapped, ref = _mapped(0, 8, 2)
    assert mapped.n_luts > 1
    dp = synth.compile_device_plan(mapped)
    words = synth.random_words(mapped.n_pis, n_words, seed=n_words)
    plane = lut_eval(_i32(words), *_dplan_tensors(dp), n_wires=dp.n_wires)
    assert plane.dtype == torch.int32
    assert plane.shape == (dp.n_wires + 1, n_words)
    want = ref_lut_eval_ref(
        jnp.asarray(words.view(np.int32)),
        jnp.asarray(dp.leaf_idx.reshape(-1, dp.k)),
        jnp.asarray(dp.tt_bits.reshape(-1, 1 << dp.k).view(np.int32)),
        jnp.asarray(dp.out_wires.reshape(-1)), dp.n_pis, dp.n_wires)
    np.testing.assert_array_equal(plane.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        _outputs(plane.numpy().view(np.uint32), dp.out_idx, dp.out_neg),
        ref_synth.execute_packed(ref, words))


@pytest.mark.parametrize("n_words,tile_rows", [
    (1, 32), (7, 8), (130, 8), (130, 32)])
def test_streamed_plain_matches_reference(n_words, tile_rows):
    mapped, ref = _mapped(0, 8, 2)
    tp = synth.compile_tile_plan(_compile_plan(mapped), mapped.n_pis,
                                 mapped.k, tile_rows)
    if tile_rows == 8:
        assert tp.n_tiles > tp.n_levels      # multi-tile levels
    words = synth.random_words(mapped.n_pis, n_words, seed=n_words)
    plane = lut_eval_streamed(_i32(words), *_tplan_tensors(tp),
                              n_rows=tp.n_rows)
    assert plane.shape == (tp.n_rows, n_words)
    rtp = ref_synth.compile_tile_plan(ref_compile_plan(ref), ref.n_pis,
                                      ref.k, tile_rows)
    want = ref_lut_eval_streamed(words, rtp, gather="fancy", interpret=True)
    np.testing.assert_array_equal(plane.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        _outputs(plane.numpy().view(np.uint32), tp.out_idx, tp.out_neg),
        ref_synth.execute_packed(ref, words))


def test_constant_network_both_walks():
    mapped, ref = _constant()
    assert mapped.n_luts == 0
    words = synth.random_words(3, 4, seed=0)
    want = ref_synth.execute_packed(ref, words)
    dp = synth.compile_device_plan(mapped, tile_rows=8)
    plane = lut_eval(_i32(words), *_dplan_tensors(dp), n_wires=dp.n_wires)
    np.testing.assert_array_equal(
        _outputs(plane.numpy().view(np.uint32), dp.out_idx, dp.out_neg), want)
    tp = dp.tiles
    plane = lut_eval_streamed(_i32(words), *_tplan_tensors(tp),
                              n_rows=tp.n_rows)
    np.testing.assert_array_equal(
        _outputs(plane.numpy().view(np.uint32), tp.out_idx, tp.out_neg), want)


def test_exhaustive_small_netlists():
    """Every input pattern of small random netlists, both walks."""
    rng = np.random.default_rng(5)
    for n in (2, 4, 5):
        aig = synth.AIG(n)
        aig.outputs = [table_to_aig(aig, rng.random(1 << n) < 0.5, None,
                                    [2 * (i + 1) for i in range(n)])
                       for _ in range(2)]
        mapped, ref = _both(synth.synthesize(aig))
        pats = synth.input_patterns(n)
        want = ref_synth.execute_packed(ref, pats)
        dp = synth.compile_device_plan(mapped, tile_rows=2)
        plane = lut_eval(_i32(pats), *_dplan_tensors(dp), n_wires=dp.n_wires)
        np.testing.assert_array_equal(
            _outputs(plane.numpy().view(np.uint32), dp.out_idx, dp.out_neg),
            want)
        tp = dp.tiles
        plane = lut_eval_streamed(_i32(pats), *_tplan_tensors(tp),
                                  n_rows=tp.n_rows)
        np.testing.assert_array_equal(
            _outputs(plane.numpy().view(np.uint32), tp.out_idx, tp.out_neg),
            want)


def test_level_starts_and_block_plan():
    np.testing.assert_array_equal(
        level_starts(np.array([0, 0, 1, 2, 2, 2], np.int32)), [0, 2, 3, 6])
    assert level_starts(np.zeros((0,), np.int32)).tolist() == [0]
    # JSC-S-sized plane at serving width: one block, plane in shared memory
    assert plan_block(180, 8) == (8, True)
    # a JSC-M-sized plane narrows the word tile to fit 227 KB
    bw, smem = plan_block(2_100, 130)
    assert smem and bw * 2_100 * 4 <= DEFAULT_SPEC.tile.smem_budget_bytes
    assert bw == DEFAULT_SPEC.tile.smem_budget_bytes // (2_100 * 4)
    # a plane too tall for one column stays in device memory
    assert plan_block(100_000, 4) == (4, False)
    # the spec's budget and word tile bound the choice
    assert plan_block(180, 8, DEFAULT_SPEC.with_tile(
        smem_budget_bytes=3 * 180 * 4)) == (3, True)
    assert plan_block(180, 130, DEFAULT_SPEC.with_tile(block_w=16)) == \
        (16, True)


def test_streamed_plan_layout():
    """The streamed walk's shared memory, as the kernel's StreamLayout
    lays it out: level_start + out_base, the plan area, the plane, each
    part rounded up to 16 bytes."""
    # JSC-S served batch: 5 levels, 7 tiles of 32 slots at k = 6, W = 8
    meta, tt, leaf = 4 * 16, 7 * 32 * (64 + 4) * 4, 7 * 32 * 6 * 4
    assert streamed_smem_bytes(5, 7, 32, 6, 7, 257, 8, True) == \
        meta + tt + leaf + 257 * 8 * 4
    assert streamed_smem_bytes(5, 7, 32, 6, 99, 257, 8, False) == \
        meta + tt + leaf                 # chunk >= n_tiles: staged whole
    # streamed: two regions of `chunk` tiles; INIT rows 16 bytes apart
    # at k = 1, leaf rows rounded up to 16 bytes
    assert streamed_smem_bytes(2, 9, 3, 1, 1, 40, 1, True) == \
        4 * (12 + 24 + 8 + 40)


@pytest.mark.parametrize("n_rows,w,n_levels,n_tiles,T,k,want", [
    (257, 8, 5, 7, 32, 6, (8, True, 7)),       # JSC-S served: staged
    (300, 256, 30, 40, 32, 2, (32, True, 40)),  # an AIG as k=2 LUTs
    (10, 1, 0, 0, 32, 1, (1, True, 1)),        # no LUTs at all
])
def test_streamed_plan_stages_what_fits(n_rows, w, n_levels, n_tiles, T, k,
                                        want):
    assert plan_streamed(n_rows, w, n_levels, n_tiles, T, k) == want


def test_streamed_plan_streams_what_does_not_fit():
    budget = DEFAULT_SPEC.tile.smem_budget_bytes
    # the ~2,000-LUT, depth-12 netlist: 72 tiles (682 KB) at k = 6 stream
    # one level (6 tiles) at a time in half the budget; the plane takes
    # the rest
    bw, smem, chunk = plan_streamed(2369, 130, 12, 72, 32, 6)
    assert (smem, chunk) == (True, 6)
    used = streamed_smem_bytes(12, 72, 32, 6, chunk, 2369, bw, True)
    assert used <= budget < used + 2369 * 4
    assert streamed_smem_bytes(12, 72, 32, 6, chunk + 1, 0, 0, False) > \
        budget // 2
    # a plane too tall for one column beside the plan: device memory,
    # and the plan takes the whole budget
    bw, smem, chunk = plan_streamed(100_000, 4, 12, 72, 32, 6)
    assert (bw, smem) == (4, False) and 6 < chunk < 72
    assert streamed_smem_bytes(12, 72, 32, 6, chunk, 0, 0, False) <= \
        budget < streamed_smem_bytes(12, 72, 32, 6, chunk + 1, 0, 0, False)
    # a small budget cuts a level into one-tile chunks
    tight = DEFAULT_SPEC.with_tile(smem_budget_bytes=40_000)
    assert plan_streamed(2369, 7, 12, 72, 32, 6, tight) == (2, True, 1)
    with pytest.raises(ValueError, match="does not fit"):
        plan_streamed(50, 1, 1, 1, 32, 6,
                      DEFAULT_SPEC.with_tile(smem_budget_bytes=5_000))


def test_stacked_plan_layout():
    """The monolithic walk's shared memory, as the kernel's WalkLayout
    lays it out for a level-stacked plan: no meta, the plan area (INIT
    rows, leaf rows, each slot's output row), the plane, each part
    rounded up to 16 bytes."""
    # JSC-S served batch: 5 levels x 62 slots at k = 6, 167 rows, W = 8
    tt, leaf, rows = 310 * (64 + 4) * 4, 310 * 6 * 4, 312 * 4
    assert stacked_smem_bytes(5, 62, 6, 310, 167, 8, True) == \
        tt + leaf + rows + 167 * 8 * 4
    assert stacked_smem_bytes(5, 62, 6, 999, 167, 8, False) == \
        tt + leaf + rows                 # chunk >= n_slots: staged whole
    # streamed: two regions of `chunk` slots, leaf and row areas rounded
    # up to 16 bytes
    assert stacked_smem_bytes(2, 3, 1, 1, 40, 1, True) == \
        4 * (8 + 4 + 4 + 40)


@pytest.mark.parametrize("n_rows,w,n_levels,lw,k,want", [
    (167, 8, 5, 62, 6, (8, True, 310)),         # JSC-S served: staged
    (300, 256, 30, 40, 2, (32, True, 1200)),    # an AIG as k=2 LUTs
    (10, 1, 0, 0, 1, (1, True, 1)),             # no LUTs at all
])
def test_stacked_plan_stages_what_fits(n_rows, w, n_levels, lw, k, want):
    assert plan_stacked(n_rows, w, n_levels, lw, k) == want


def test_stacked_plan_streams_what_does_not_fit():
    budget = DEFAULT_SPEC.tile.smem_budget_bytes
    # the 2,040-LUT, depth-12 netlist (12 levels of 170 slots, 612 KB at
    # k = 6) streams level by level in half the budget; the plane takes
    # the rest
    bw, smem, chunk = plan_stacked(2106, 130, 12, 170, 6)
    assert (smem, chunk) == (True, 170)
    used = stacked_smem_bytes(12, 170, 6, chunk, 2106, bw, True)
    assert used <= budget < used + 2106 * 4
    assert stacked_smem_bytes(12, 170, 6, 12 * 170, 0, 0, False) > budget
    # a plane too tall for one column beside the plan: device memory, the
    # plan still a level at a time
    assert plan_stacked(100_000, 4, 12, 170, 6) == (4, False, 170)
    # a small budget cuts a level into chunks of fewer slots
    tight = DEFAULT_SPEC.with_tile(smem_budget_bytes=40_000)
    bw, smem, chunk = plan_stacked(2106, 7, 12, 170, 6, tight)
    assert smem and 1 < chunk < 170
    assert stacked_smem_bytes(12, 170, 6, chunk, 0, 0, False) <= 20_000 < \
        stacked_smem_bytes(12, 170, 6, chunk + 1, 0, 0, False)
    with pytest.raises(ValueError, match="does not fit"):
        plan_stacked(50, 1, 1, 4, 6,
                     DEFAULT_SPEC.with_tile(smem_budget_bytes=500))


def test_wrapper_rejects_bad_arguments():
    mapped, _ = _mapped(0, 8, 2)
    dp = synth.compile_device_plan(mapped)
    words = _i32(synth.random_words(mapped.n_pis, 2, seed=0))
    leaf, tt, ow = _dplan_tensors(dp)
    with pytest.raises(ValueError, match="int32"):
        lut_eval(words.to(torch.int64), leaf, tt, ow, n_wires=dp.n_wires)
    with pytest.raises(ValueError, match="3-D"):
        lut_eval(words, leaf.reshape(-1, dp.k), tt, ow, n_wires=dp.n_wires)
    with pytest.raises(ValueError, match="contiguous"):
        lut_eval(words.T.contiguous().T, leaf, tt, ow, n_wires=dp.n_wires)
    with pytest.raises(ValueError, match="disagree"):
        lut_eval(words, leaf, tt[:, :, :8].contiguous(), ow,
                 n_wires=dp.n_wires)
