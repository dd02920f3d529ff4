"""``execute_packed`` through each walk — ``repro_torch.synth``'s
``execute_packed_cuda`` and ``execute_packed_streamed`` — against the
reference, and the executor registry and autotune cache writes.

Each test twins one of the reference's ``tests/test_lut_eval.py`` tests
that call ``execute_packed_pallas`` / ``execute_packed_streamed`` (same
name but for the engine). Four of those fail in the reference (the
installed JAX has no Pallas ``load`` / ``store``: the monolithic
kernel and the streamed kernel's ``"dma"`` gather), so here the port's
functions run on the CPU (the walks' plain versions) and are held bit
for bit against ``execute_packed`` of both packages, the reference's
jnp scan oracle (``kernels/lut_eval/ref.py``) and, for the streamed
walk, the reference's own ``execute_packed_streamed`` in its working
``"fancy"`` gather mode. The CUDA kernels are held against
``execute_packed`` on the card in test_torch_gpu.py.
"""
import functools
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
from hyp_compat import given, settings, st

import repro.synth as RS
from repro.kernels.lut_eval import lut_eval_ref as ref_lut_eval_ref
from repro.synth.executor import _compile_plan as ref_compile_plan
from repro_torch import synth
from repro_torch.synth import (execute_packed, execute_packed_cuda,
                               execute_packed_streamed, input_patterns,
                               random_words)
from repro_torch.synth.executor import _compile_plan
from repro_torch.synth.from_sop import table_to_aig


def _both(mapped):
    """A port ``MappedNetwork`` and the same netlist as the reference's."""
    ref = RS.MappedNetwork(
        mapped.n_pis, mapped.k,
        [RS.MappedLUT(l.root, l.leaves, l.tt) for l in mapped.luts],
        list(mapped.outputs))
    return mapped, ref


@functools.lru_cache(maxsize=None)
def _random_mapped(seed: int, n_vars: int, n_outs: int, density=0.5):
    rng = np.random.default_rng(seed)
    aig = synth.AIG(n_vars)
    aig.outputs = [
        table_to_aig(aig, rng.random(1 << n_vars) < density, None,
                     [2 * (i + 1) for i in range(n_vars)])
        for _ in range(n_outs)]
    return _both(synth.synthesize(aig))


def _constant():
    aig = synth.AIG(3)
    aig.outputs = [1]           # const-1 literal
    return _both(synth.synthesize(aig))


def _tables(n, tts):
    aig = synth.AIG(n)
    aig.outputs = [
        table_to_aig(aig, np.array([bool((tt >> r) & 1)
                                    for r in range(1 << n)]),
                     None, [2 * (i + 1) for i in range(n)])
        for tt in tts]
    return _both(synth.synthesize(aig))


def _scan_oracle(ref, words):
    """Output words of the reference's jnp scan oracle over its plan."""
    dp = RS.compile_device_plan(ref, ref_compile_plan(ref))
    if dp.n_levels == 0:
        return RS.execute_packed(ref, words)
    plane = np.asarray(ref_lut_eval_ref(
        jnp.asarray(words.view(np.int32)),
        jnp.asarray(dp.leaf_idx.reshape(-1, dp.k), jnp.int32),
        jnp.asarray(np.ascontiguousarray(
            dp.tt_bits.reshape(-1, 1 << dp.k)).view(np.int32)),
        jnp.asarray(dp.out_wires.reshape(-1), jnp.int32),
        dp.n_pis, dp.n_wires)).view(np.uint32)
    out = plane[dp.out_idx]
    out[dp.out_neg] = ~out[dp.out_neg]
    return out


def _assert_monolithic(mapped, ref, words, scan=True):
    got = execute_packed_cuda(mapped, words, device="cpu")
    assert got.dtype == np.uint32
    assert got.shape == (len(mapped.outputs), words.shape[1])
    want = execute_packed(mapped, words)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, RS.execute_packed(ref, words))
    if scan:
        np.testing.assert_array_equal(got, _scan_oracle(ref, words))


def _assert_streamed(mapped, ref, words, tile_rows=32, tplan=None):
    got = execute_packed_streamed(mapped, words, tplan=tplan,
                                  tile_rows=tile_rows, device="cpu")
    assert got.dtype == np.uint32
    assert got.shape == (len(mapped.outputs), words.shape[1])
    np.testing.assert_array_equal(got, execute_packed(mapped, words))
    np.testing.assert_array_equal(got, RS.execute_packed(ref, words))
    rtp = RS.compile_tile_plan(ref_compile_plan(ref), ref.n_pis, ref.k,
                               tile_rows)
    np.testing.assert_array_equal(
        got, RS.execute_packed_streamed(ref, words, tplan=rtp,
                                        gather="fancy"))


# ---------------------------------------------------------------------------
# monolithic walk (reference: execute_packed_pallas)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_words", [1, 7, 130])
def test_cuda_walk_matches_numpy_fold_ragged(n_words):
    """Ragged word counts match the host fold bit-exactly."""
    mapped, ref = _random_mapped(0, 9, 3)
    assert mapped.n_luts > 1
    words = random_words(mapped.n_pis, n_words, seed=n_words)
    _assert_monolithic(mapped, ref, words)


def test_cuda_walk_takes_a_compiled_plan():
    """A given ``dplan`` is used as is; without one the plan is compiled,
    with the same result."""
    mapped, ref = _random_mapped(0, 9, 3)
    words = random_words(mapped.n_pis, 7, seed=7)
    dp = synth.compile_device_plan(mapped)
    np.testing.assert_array_equal(
        execute_packed_cuda(mapped, words, dplan=dp, device="cpu"),
        execute_packed_cuda(mapped, words, device="cpu"))


def test_trivial_constant_network():
    """A constant function maps to zero LUTs; the walk's no-slot path
    still produces the complemented constant plane."""
    mapped, ref = _constant()
    assert mapped.n_luts == 0
    words = random_words(3, 4, seed=0)
    _assert_monolithic(mapped, ref, words)


@settings(max_examples=15, deadline=None)
@given(n=st.integers(1, 5), n_outs=st.integers(1, 3), data=st.data())
def test_lut_eval_exhaustive_property(n, n_outs, data):
    """Random mapped netlists agree with the host fold on every input
    pattern through the monolithic walk (exhaustive packed
    simulation)."""
    mapped, ref = _tables(n, [data.draw(st.integers(0, (1 << (1 << n)) - 1))
                              for _ in range(n_outs)])
    _assert_monolithic(mapped, ref, input_patterns(n))


# ---------------------------------------------------------------------------
# streamed walk (reference: execute_packed_streamed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_words", [1, 7, 130])
def test_streamed_matches_numpy_fold_ragged(n_words):
    """The streamed walk matches the host fold and the reference's
    streamed kernel bit-exactly on ragged word counts."""
    mapped, ref = _random_mapped(0, 9, 3)
    words = random_words(mapped.n_pis, n_words, seed=n_words)
    _assert_streamed(mapped, ref, words)


def test_streamed_constant_network():
    mapped, ref = _constant()
    assert mapped.n_luts == 0
    words = random_words(3, 4, seed=0)
    _assert_streamed(mapped, ref, words)


def test_streamed_multi_tile_levels():
    """tile_rows smaller than every level forces multi-tile bands;
    results stay bit-identical, from the plan given or compiled at that
    tile size."""
    mapped, ref = _random_mapped(4, 10, 4)
    plan = _compile_plan(mapped)
    tp = synth.compile_tile_plan(plan, mapped.n_pis, mapped.k, tile_rows=8)
    assert tp.n_tiles > len(plan.levels)     # levels actually split
    words = random_words(mapped.n_pis, 9, seed=2)
    _assert_streamed(mapped, ref, words, tile_rows=8, tplan=tp)
    _assert_streamed(mapped, ref, words, tile_rows=8)


@settings(max_examples=10, deadline=None)
@given(n=st.integers(1, 5), n_outs=st.integers(1, 3),
       tile_rows=st.sampled_from([1, 2, 8, 32]), data=st.data())
def test_streamed_exhaustive_property(n, n_outs, tile_rows, data):
    """Random mapped netlists agree with the host fold on every input
    pattern through the streamed walk, at tile sizes from degenerate
    (1 slot/tile) to larger-than-any-level."""
    mapped, ref = _tables(n, [data.draw(st.integers(0, (1 << (1 << n)) - 1))
                              for _ in range(n_outs)])
    _assert_streamed(mapped, ref, input_patterns(n), tile_rows=tile_rows)


def test_over_smem_netlist_runs_streamed():
    """The reference refuses the monolithic plan over its VMEM budget and
    runs the netlist streamed. Here a plane over the shared-memory
    budget is no error (the walk keeps it in device memory, by design):
    at a budget that leaves the streamed walk's plane in device memory
    the tiled plan validates, and both walks execute it bit-identically
    to the host fold."""
    from repro_torch.check import validate_device_plan
    # the reference's (6, 10, 16) takes 40 s to synthesize on the CPU
    mapped, ref = _random_mapped(6, 8, 8)
    dp_t = synth.compile_device_plan(mapped, tile_rows=8)
    rep = validate_device_plan(dp_t, smem_budget_bytes=5000,
                               use_cache=False)
    assert rep.ok, rep.format()
    assert rep.info["lut_eval_streamed"]["plane"] == "device"
    words = random_words(mapped.n_pis, 33, seed=7)
    want = execute_packed(mapped, words)
    np.testing.assert_array_equal(want, RS.execute_packed(ref, words))
    np.testing.assert_array_equal(
        want, execute_packed_streamed(mapped, words, tplan=dp_t.tiles,
                                      device="cpu"))
    np.testing.assert_array_equal(
        want, execute_packed_cuda(mapped, words, dplan=dp_t, device="cpu"))


# ---------------------------------------------------------------------------
# executor registry and the autotune cache
# ---------------------------------------------------------------------------

def test_executor_registry_typed_error_and_custom_engine():
    from repro_torch.synth import executors

    with pytest.raises(executors.UnknownEngineError):
        executors.get("definitely-not-an-engine")
    try:
        executors.get("definitely-not-an-engine")
    except executors.UnknownEngineError as e:
        assert "numpy" in str(e) and "cuda-streamed" in str(e)
        assert "cuda" in e.known
    for builtin in ("numpy", "cuda", "cuda-streamed"):
        assert builtin in executors.names()
    # a custom engine is one call, and is then listed and resolved
    def build(bitnet, spec=None):
        return None
    try:
        assert executors.register("custom-test-engine", build) is build
        assert executors.get("custom-test-engine") is build
        assert "custom-test-engine" in executors.names()
    finally:
        executors._REGISTRY.pop("custom-test-engine", None)
    assert "custom-test-engine" not in executors.names()


def test_autotune_cache_concurrent_writers(tmp_path, monkeypatch):
    """Many threads recording tuned shapes into one cache file: the
    mkstemp+replace write means the file is a valid JSON snapshot at
    every instant and no entry is torn — a pid-suffixed temp name would
    let two threads of this one process interleave."""
    from repro_torch.kernels.lut_eval import autotune

    path = tmp_path / "tiles.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    stop = threading.Event()
    torn = []

    def reader():
        while not stop.is_set():
            if path.exists():
                try:
                    json.loads(path.read_text())
                except ValueError as e:        # torn/partial write
                    torn.append(e)

    def writer(i):
        for j in range(25):
            autotune.record(f"fp{i}", "cpu", tile_rows=32, block_w=128,
                            us=float(j))

    r = threading.Thread(target=reader)
    ws = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    r.start()
    for w in ws:
        w.start()
    for w in ws:
        w.join()
    stop.set()
    r.join()
    assert not torn
    # each writer's own final key must be readable (no lost keys across
    # writers is NOT guaranteed: last write wins)
    final = json.loads(path.read_text())
    assert final, "cache file empty after concurrent writes"
    for key, ent in final.items():
        assert ent["tile_rows"] == 32 and ent["block_w"] == 128
    assert autotune.lookup(next(iter(final)).split(":")[0],
                           "cpu") == (32, 128)
    assert not list(tmp_path.glob("*.tmp")), "leaked temp files"
