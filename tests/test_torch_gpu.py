"""The port's CUDA kernels against their plain torch versions, on the
card. Every test here needs a CUDA device and skips without one; none
imports JAX or the reference package, so the file runs on a machine
with only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import synth
from repro_torch.kernels.lut_eval import (level_starts, lut_eval, lut_eval_ref,
                                          lut_eval_streamed,
                                          lut_eval_streamed_ref)
from repro_torch.kernels.lut_layer import lut_layer, lut_layer_ref
from repro_torch.synth.from_sop import table_to_aig

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _i32(a, device):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                            .copy()).to(device)


@pytest.fixture(scope="module")
def mapped():
    rng = np.random.default_rng(0)
    aig = synth.AIG(8)
    aig.outputs = [table_to_aig(aig, rng.random(256) < 0.5, None,
                                [2 * (i + 1) for i in range(8)])
                   for _ in range(2)]
    return synth.synthesize(aig)


@pytest.mark.parametrize("n_words,tile_rows", [(1, 8), (7, 32), (130, 8)])
def test_lut_eval_kernels_match_plain(cuda_device, mapped, n_words,
                                      tile_rows):
    dp = synth.compile_device_plan(mapped, tile_rows=tile_rows)
    words = _i32(synth.random_words(mapped.n_pis, n_words, seed=n_words),
                 cuda_device)
    args = [_i32(a, cuda_device) for a in (dp.leaf_idx, dp.tt_bits,
                                           dp.out_wires)]
    launches = lut_eval.launches
    got = lut_eval(words, *args, n_wires=dp.n_wires)
    torch.cuda.synchronize()
    assert lut_eval.launches == launches + 1
    assert torch.equal(got, lut_eval_ref(words, *args, n_wires=dp.n_wires))
    tp = dp.tiles
    targs = [_i32(a, cuda_device) for a in (
        tp.tt_tiles, tp.leaf_tiles, tp.out_base,
        level_starts(tp.level_of_tile))]
    launches = lut_eval_streamed.launches
    got = lut_eval_streamed(words, *targs, n_rows=tp.n_rows)
    torch.cuda.synchronize()
    assert lut_eval_streamed.launches == launches + 1
    assert torch.equal(got, lut_eval_streamed_ref(words, *targs,
                                                  n_rows=tp.n_rows))


@pytest.mark.parametrize("B,n_in,N,K,L", [
    (8, 16, 32, 3, 2), (130, 20, 50, 4, 2), (64, 64, 128, 6, 2),
    (33, 10, 7, 2, 4), (16, 24, 200, 5, 3), (256, 64, 32, 3, 3),
    (70, 30, 9, 6, 3)])      # 729-row tables: read from device memory
def test_lut_layer_kernel_matches_plain(cuda_device, B, n_in, N, K, L):
    rng = np.random.default_rng(B * 7 + N)
    codes, idx, tables = (
        torch.from_numpy(a.astype(np.int32)).to(cuda_device) for a in (
            rng.integers(0, L, (B, n_in)), rng.integers(0, n_in, (N, K)),
            rng.integers(0, 8, (N, L ** K))))
    launches = lut_layer.launches
    got = lut_layer(codes, idx, tables, L)
    torch.cuda.synchronize()
    assert lut_layer.launches == launches + 1
    assert torch.equal(got, lut_layer_ref(codes, idx, tables, L))


def test_engines_serve_identically_on_card(cuda_device):
    """A small seeded network: the device engines and lut_layer on the
    card give the CPU gather path's labels."""
    from repro_torch.configs.jsc import JSC_DEMO
    from repro_torch.data.jsc import make_jsc
    from repro_torch.models.mlp import final_masks, init_mlp, to_logic
    from repro_torch.serving.engine import LogicEngine
    model = init_mlp(JSC_DEMO, torch.Generator().manual_seed(3))
    model.set_masks(final_masks(JSC_DEMO, model))
    net = to_logic(JSC_DEMO, model)
    x = make_jsc(300, seed=5)[0]
    want = LogicEngine(net, 5, max_batch=128, device="cpu").classify(x)
    for backend, engine in (("bitplane", "cuda-streamed"),
                            ("bitplane", "cuda"), ("lut_layer", "numpy")):
        eng = LogicEngine(net, 5, max_batch=128, backend=backend,
                          engine=engine, device=cuda_device)
        np.testing.assert_array_equal(eng.classify(x), want)
