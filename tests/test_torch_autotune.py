"""The streamed walk's persisted autotune cache
(``repro_torch.kernels.lut_eval.autotune``), on the CPU with the cache
file in ``tmp_path``: the store/lookup round trip, the key by plan
fingerprint and device name, a corrupt or foreign cache ignored, the
sweep persisting its winner, and ``_CudaStreamedExecutor`` (and the
serving preflight) taking a cached geometry when built without a spec.
The sweep on the card is in ``tests/test_torch_gpu.py``."""
import json

import numpy as np
import pytest
import torch

from repro_torch import synth
from repro_torch.check import plan_fingerprint, preflight
from repro_torch.kernels import launch_counts
from repro_torch.kernels.lut_eval import autotune
from repro_torch.kernels.spec import DEFAULT_SPEC
from repro_torch.synth.executor import (BitplaneNetwork,
                                        _CudaStreamedExecutor,
                                        compile_device_plan)
from repro_torch.synth.from_sop import table_to_aig


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "sub" / "tiles.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    return path


@pytest.fixture(scope="module")
def bitnet():
    """A mapped two-layer network with its LogicNetwork, on the CPU."""
    from repro_torch.core.logic_infer import LogicNetwork
    from repro_torch.core.quant import ActQuantSpec
    from repro_torch.core.truthtable import LayerTables

    rng = np.random.default_rng(0)
    spec = ActQuantSpec("signed", 2)
    layers = []
    for n_in, n_out in ((6, 5), (5, 3)):
        idx = np.stack([rng.choice(n_in, 3, replace=False)
                        for _ in range(n_out)]).astype(np.int32)
        tables = rng.integers(0, spec.n_levels, (n_out, spec.n_levels ** 3))
        layers.append(LayerTables(idx, tables.astype(np.int32), spec, spec,
                                  1.0, 1.0))
    net = LogicNetwork(layers, spec, 1.0, 6, 3)
    return BitplaneNetwork.from_logic_network(net, engine="cuda-streamed",
                                              device="cpu")


def test_cache_round_trip_is_atomic_and_keyed(cache):
    assert autotune.cache_path() == str(cache)
    assert autotune.lookup("abc", "NVIDIA H100 80GB HBM3") is None
    autotune.record("abc", "NVIDIA H100 80GB HBM3", 64, 4, 3.5)
    autotune.record("abc", "cpu", 16, 32, 900.0)
    autotune.record("def", "NVIDIA H100 80GB HBM3", 128, 32, 4.0)
    assert autotune.lookup("abc", "NVIDIA H100 80GB HBM3") == (64, 4)
    assert autotune.lookup("abc", "cpu") == (16, 32)
    assert autotune.lookup("def", "NVIDIA H100 80GB HBM3") == (128, 32)
    assert autotune.lookup("abc", "NVIDIA A100-SXM4-80GB") is None
    data = json.loads(cache.read_text())
    assert data["abc:NVIDIA H100 80GB HBM3"]["us"] == 3.5
    assert [p.name for p in cache.parent.iterdir()] == ["tiles.json"]
    autotune.record("abc", "cpu", 32, 8, 800.0)         # last write wins
    assert autotune.lookup("abc", "cpu") == (32, 8)


def test_device_name_keys_the_cache():
    assert autotune.device_name("cpu") == "cpu"
    assert autotune.device_name(torch.device("cpu")) == "cpu"


@pytest.mark.parametrize("text", ["{nope", "[1, 2]", '{"k:cpu": 5}',
                                  '{"k:cpu": {"tile_rows": "x"}}'])
def test_corrupt_cache_is_ignored(cache, text):
    cache.parent.mkdir(parents=True)
    cache.write_text(text)
    assert autotune.lookup("k", "cpu") is None
    autotune.record("k", "cpu", 16, 32, 1.0)            # rewritten whole
    assert autotune.lookup("k", "cpu") == (16, 32)


def test_empty_env_disables_persistence(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "")
    assert autotune.cache_path() is None
    autotune.record("k", "cpu", 16, 32, 1.0)
    assert autotune.lookup("k", "cpu") is None


def test_executor_takes_cached_geometry(cache, bitnet):
    dp = compile_device_plan(bitnet.mapped, bitnet._plan)
    ex = _CudaStreamedExecutor(bitnet)
    assert ex.spec == DEFAULT_SPEC and ex.tp.tile_rows == 32
    assert autotune.cached_tile(dp, "cpu") is None
    autotune.record(plan_fingerprint(dp), "cpu", 4, 2, 1.0)
    assert autotune.cached_tile(dp, "cpu") == (4, 2)
    ex = _CudaStreamedExecutor(bitnet)
    assert (ex.spec.tile.tile_rows, ex.spec.tile.block_w) == (4, 2)
    assert ex.tp.tile_rows == 4
    # an explicit spec wins over the cache
    ex = _CudaStreamedExecutor(bitnet, spec=DEFAULT_SPEC)
    assert ex.tp.tile_rows == 32
    # a card's entry is not the CPU's
    autotune.record(plan_fingerprint(dp), "NVIDIA H100 80GB HBM3", 64, 8,
                    1.0)
    assert _CudaStreamedExecutor(bitnet).tp.tile_rows == 4
    # the preflight checks the plan the tuned executor launches
    rep = preflight(bitnet, n_samples=32)
    assert rep.ok, rep.format()
    assert rep.info["tile_rows"] == 4
    assert rep.info["lut_eval_streamed"]["block_w"] == 2
    x = np.random.default_rng(1).normal(size=(70, 6)).astype(np.float32)
    want = bitnet.net.apply_codes(bitnet.quantize(x)).numpy()
    np.testing.assert_array_equal(
        ex.apply_codes(bitnet.quantize(x).numpy()), want)


def test_autotune_streamed_persists_its_winner(cache, bitnet):
    words = bitnet.pack_inputs(np.random.default_rng(2).normal(
        size=(256, 6)).astype(np.float32))
    assert words.shape == (bitnet.mapped.n_pis, 8)
    timings = []
    before = launch_counts()
    best = autotune.autotune_streamed(
        bitnet, words, candidates=((8, 32), (16, 4), (32, 32)), iters=2,
        timings=timings)
    assert launch_counts() == before         # the CPU runs plain versions
    assert [t[:2] for t in timings] == [(8, 32), (16, 4), (32, 32)]
    assert all(t[2] > 0 for t in timings)
    assert best == min(timings, key=lambda t: t[2])
    dp = compile_device_plan(bitnet.mapped, bitnet._plan)
    assert autotune.cached_tile(dp, "cpu") == best[:2]
    ex = _CudaStreamedExecutor(bitnet)
    assert (ex.spec.tile.tile_rows, ex.spec.tile.block_w) == best[:2]
    with pytest.raises(ValueError):
        autotune.autotune_streamed(bitnet, words, candidates=())
