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
from repro_torch.device import NoCudaDeviceError
from repro_torch.kernels.aig_sim import (aig_sim, aig_sim_ref, aig_sim_walk,
                                         max_sweeps, plan_walk)
from repro_torch.kernels.fanin_matmul import fanin_matmul, fanin_matmul_ref
from repro_torch.kernels.flash_attention import (attention_backward_ref,
                                                 attention_lse_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_backward,
                                                 flash_attention_forward)
from repro_torch.kernels.lut_eval import (level_starts, lut_eval, lut_eval_ref,
                                          lut_eval_streamed,
                                          lut_eval_streamed_ref,
                                          plan_stacked, plan_streamed,
                                          stacked_smem_bytes)
from repro_torch.kernels.lut_eval.ops import streamed_smem_bytes, tt_stride
from repro_torch.kernels.spec import DEFAULT_SPEC
from repro_torch.synth.executor import _compile_plan
from repro_torch.kernels.lut_layer import lut_layer, lut_layer_ref, plan_layer
from repro_torch.kernels.xnor_popcount import (pack_bipolar,
                                               xnor_matmul_packed,
                                               xnor_popcount_ref)
from repro_torch.kernels.xnor_popcount.ops import loads_vectorized
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


@pytest.mark.parametrize("n_words,tile_rows", [(1, 8), (7, 32), (130, 8)])
def test_execute_packed_walks_on_card_match_host_fold(cuda_device, mapped,
                                                      n_words, tile_rows):
    """``execute_packed_cuda`` / ``execute_packed_streamed`` launch their
    walk on the card (the default device) and give ``execute_packed``'s
    words."""
    words = synth.random_words(mapped.n_pis, n_words, seed=n_words)
    want = synth.execute_packed(mapped, words)
    launches = lut_eval.launches
    got = synth.execute_packed_cuda(mapped, words)
    assert lut_eval.launches == launches + 1
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    launches = lut_eval_streamed.launches
    got = synth.execute_packed_streamed(mapped, words, tile_rows=tile_rows)
    assert lut_eval_streamed.launches == launches + 1
    np.testing.assert_array_equal(got, want)


def random_netlist(seed, k, n_pis=20, n_levels=4, width=70):
    """A random mapped k-LUT netlist of exactly ``n_levels`` levels of
    ``width`` LUTs, 1 to k leaves each (one from the level below), with
    random INIT vectors."""
    rng = np.random.default_rng(seed)
    below = list(range(1, n_pis + 1))
    earlier = [0] + below
    luts, node = [], n_pis + 1
    for _ in range(n_levels):
        level = []
        for _ in range(width):
            m = int(rng.integers(1, k + 1))
            leaves = [int(rng.choice(below))]
            leaves += [int(x) for x in rng.choice(earlier, m - 1)]
            tt = (int.from_bytes(rng.bytes(8), "little")
                  & ((1 << (1 << m)) - 1))
            luts.append(synth.MappedLUT(node, tuple(leaves), tt))
            level.append(node)
            node += 1
        earlier += level
        below = level
    return synth.MappedNetwork(n_pis, k, luts,
                               [2 * x for x in below[:8]])


def plan_budget(mode, n_levels, n_tiles, T, k):
    """A shared-memory budget that puts the streamed walk on one branch:
    the default ("staged": the whole plan beside the plane), ten tiles
    ("streamed": two regions of two tiles, the plane beside them), or
    two one-tile regions and nothing more ("device": the plane in device
    memory)."""
    if mode == "staged":
        return DEFAULT_SPEC
    if mode == "streamed":
        budget = 10 * 4 * T * (tt_stride(k) + k) + 512
    else:
        budget = streamed_smem_bytes(n_levels, n_tiles, T, k, 1, 0, 0,
                                     False) + 64
    return DEFAULT_SPEC.with_tile(smem_budget_bytes=budget)


@pytest.mark.parametrize("mode", ["staged", "streamed", "device"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
def test_lut_eval_plan_branches_match_plain(cuda_device, k, mode):
    """Every fold width through both walks, and the streamed walk on each
    of its branches (``plan_budget``)."""
    mapped = random_netlist(k, k)
    plan = _compile_plan(mapped)
    dp = synth.compile_device_plan(mapped, plan)
    tp = synth.compile_tile_plan(plan, mapped.n_pis, k, 8)
    ls = level_starts(tp.level_of_tile)
    n_levels, n_tiles = ls.shape[0] - 1, tp.out_base.shape[0]
    spec = plan_budget(mode, n_levels, n_tiles, 8, k)
    for n_words in (1, 7, 40):
        words = _i32(synth.random_words(mapped.n_pis, n_words, seed=k),
                     cuda_device)
        _, smem, chunk = plan_streamed(tp.n_rows, n_words, n_levels,
                                       n_tiles, 8, k, spec)
        assert (chunk >= n_tiles, smem) == (mode == "staged",
                                            mode != "device")
        assert mode == "staged" or chunk < int(np.diff(ls).max())
        targs = [_i32(a, cuda_device) for a in (
            tp.tt_tiles, tp.leaf_tiles, tp.out_base, ls)]
        got = lut_eval_streamed(words, *targs, n_rows=tp.n_rows, spec=spec)
        torch.cuda.synchronize()
        assert torch.equal(got, lut_eval_streamed_ref(words, *targs,
                                                      n_rows=tp.n_rows))
        args = [_i32(a, cuda_device) for a in (dp.leaf_idx, dp.tt_bits,
                                               dp.out_wires)]
        assert torch.equal(lut_eval(words, *args, n_wires=dp.n_wires),
                           lut_eval_ref(words, *args, n_wires=dp.n_wires))


def stacked_budget(mode, n_rows, n_levels, lw, k):
    """A shared-memory budget that puts the monolithic walk on one
    branch: the default ("staged": the whole plan beside the plane), two
    regions of ten slots and a plane column in each half ("streamed":
    chunks of fewer slots than a level), or two one-slot regions and
    nothing more ("device": the plane in device memory)."""
    if mode == "staged":
        return DEFAULT_SPEC
    if mode == "streamed":
        budget = 2 * (stacked_smem_bytes(n_levels, lw, k, 10, 0, 0, False)
                      + 4 * n_rows)
    else:
        budget = stacked_smem_bytes(n_levels, lw, k, 1, 0, 0, False) + 64
    return DEFAULT_SPEC.with_tile(smem_budget_bytes=budget)


@pytest.mark.parametrize("mode", ["staged", "streamed", "device"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
def test_lut_eval_stacked_branches_match_plain(cuda_device, k, mode):
    """The monolithic walk at every fold width on each of its branches
    (``stacked_budget``), against its plain version and the host fold."""
    mapped = random_netlist(k, k)
    dp = synth.compile_device_plan(mapped)
    n_levels, lw = dp.out_wires.shape
    spec = stacked_budget(mode, dp.n_wires + 1, n_levels, lw, k)
    args = [_i32(a, cuda_device) for a in (dp.leaf_idx, dp.tt_bits,
                                           dp.out_wires)]
    for n_words in (1, 7, 40):
        host_words = synth.random_words(mapped.n_pis, n_words, seed=k)
        words = _i32(host_words, cuda_device)
        _, smem, chunk = plan_stacked(dp.n_wires + 1, n_words, n_levels, lw,
                                      k, spec)
        assert (chunk >= n_levels * lw, smem) == (mode == "staged",
                                                  mode != "device")
        assert mode == "staged" or chunk < lw
        got = lut_eval(words, *args, n_wires=dp.n_wires, spec=spec)
        torch.cuda.synchronize()
        assert torch.equal(got, lut_eval_ref(words, *args,
                                             n_wires=dp.n_wires))
        out = got.cpu().numpy().view(np.uint32)[dp.out_idx]
        out[dp.out_neg] = ~out[dp.out_neg]
        np.testing.assert_array_equal(
            out, synth.execute_packed(mapped, host_words))


def misaligned(t):
    """A copy of ``t`` one int32 past a 16-byte aligned address."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    off = (4 - buf.data_ptr() % 16 // 4 + 1) % 4
    out = buf[off: off + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("mode", ["staged", "streamed", "device"])
@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
def test_lut_eval_takes_misaligned_masks(cuda_device, k, mode):
    """INIT masks one int32 past an aligned address, which the monolithic
    walk once refused, are taken by both walks on each plan branch and
    give the plain version's plane bit for bit: every mask read goes
    through the copy into shared memory, which copies word by word
    from a misaligned source."""
    mapped = random_netlist(k, k)
    plan = _compile_plan(mapped)
    dp = synth.compile_device_plan(mapped, plan)
    tp = synth.compile_tile_plan(plan, mapped.n_pis, k, 8)
    ls = level_starts(tp.level_of_tile)
    n_levels, lw = dp.out_wires.shape
    words = _i32(synth.random_words(mapped.n_pis, 7, seed=k), cuda_device)
    leaf, tt, ow = (_i32(a, cuda_device) for a in (dp.leaf_idx, dp.tt_bits,
                                                   dp.out_wires))
    spec = stacked_budget(mode, dp.n_wires + 1, n_levels, lw, k)
    _, smem, chunk = plan_stacked(dp.n_wires + 1, 7, n_levels, lw, k, spec)
    assert (chunk >= n_levels * lw, smem) == (mode == "staged",
                                              mode != "device")
    got = lut_eval(words, leaf, misaligned(tt), ow, n_wires=dp.n_wires,
                   spec=spec)
    torch.cuda.synchronize()
    assert torch.equal(got, lut_eval_ref(words, leaf, tt, ow,
                                         n_wires=dp.n_wires))
    targs = [_i32(a, cuda_device) for a in (
        tp.tt_tiles, tp.leaf_tiles, tp.out_base, ls)]
    n_tiles = tp.out_base.shape[0]
    spec = plan_budget(mode, ls.shape[0] - 1, n_tiles, 8, k)
    _, smem, chunk = plan_streamed(tp.n_rows, 7, ls.shape[0] - 1, n_tiles,
                                   8, k, spec)
    assert (chunk >= n_tiles, smem) == (mode == "staged", mode != "device")
    got = lut_eval_streamed(words, misaligned(targs[0]), *targs[1:],
                            n_rows=tp.n_rows, spec=spec)
    torch.cuda.synchronize()
    assert torch.equal(got, lut_eval_streamed_ref(words, *targs,
                                                  n_rows=tp.n_rows))


@pytest.mark.parametrize("B,n_in,N,K,L", [
    (8, 16, 32, 3, 2), (130, 20, 50, 4, 2), (64, 64, 128, 6, 2),
    (33, 10, 7, 2, 4), (16, 24, 200, 5, 3), (256, 64, 32, 3, 3),
    (70, 30, 9, 6, 3)])      # 729-row tables
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


@pytest.mark.parametrize("B,n_in,N,K,L,branch", [
    (256, 16, 64, 3, 3, "smem"),         # JSC-S layer 1: 32-neuron tiles
    (256, 32, 5, 3, 3, "smem"),          # JSC-S layer 3: the whole layer
    (256, 16, 32, 4, 7, "split"),        # JSC-L layer 1: R 2,401
    (40, 12, 20, 4, 8, "split"),         # R 4,096: two neurons a block
    (33, 10, 3, 6, 7, "device"),         # R 117,649: a table over 227 KB
    (5, 60_000, 7, 3, 3, "device")])     # a row of codes over 227 KB
def test_lut_layer_kernel_branches_match_plain(cuda_device, B, n_in, N, K,
                                               L, branch):
    """Each branch of the kernel (``plan_layer``): tables and codes
    staged in shared memory, by tiles of fewer neurons where the tables
    are large ("split"), and read from device memory where one table or
    row of codes does not fit ("device")."""
    n_tile, b_tile, smem = plan_layer(B, n_in, N, K, L ** K)
    assert smem == (branch != "device")
    assert (n_tile < min(N, 32)) == (branch == "split")
    rng = np.random.default_rng(B + N + K)
    codes, idx = (torch.from_numpy(a.astype(np.int32)).to(cuda_device)
                  for a in (rng.integers(0, L, (B, n_in)),
                            rng.integers(0, n_in, (N, K))))
    tables = torch.randint(0, 8, (N, L ** K), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(N)
                           ).to(cuda_device)
    got = lut_layer(codes, idx, tables, L)
    torch.cuda.synchronize()
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


@pytest.mark.parametrize("bn", [True, False])
def test_train_step_on_card_matches_cpu(cuda_device, bn):
    """One QAT step of full-width JSC-S from seeded weights on one batch:
    the loss, every gradient, the BN statistics and the parameters after
    AdamW on the card equal the CPU's within the CPU parity test's
    tolerance (1e-5 x max(1, |cpu|), tests/test_torch_train.py), TF32
    off. Under BN a layer's b has a gradient of rounding noise, so Adam
    moves it by up to lr in a direction rounding picks: b is compared
    only without BN."""
    import copy
    import dataclasses
    from repro_torch.configs.jsc import JSC_S
    from repro_torch.data.jsc import batches, train_test
    from repro_torch.models.mlp import init_mlp
    from repro_torch.train.jsc_trainer import TrainStep
    from repro_torch.train.optim import AdamW
    cfg = dataclasses.replace(JSC_S, bn=bn)
    (xtr, ytr), _ = train_test(4000, 1000)
    xb, yb = next(batches(xtr, ytr, 256, 0))
    init = init_mlp(cfg, torch.Generator().manual_seed(0))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", cuda_device):
            model = copy.deepcopy(init).to(dev)
            step = TrainStep(cfg, model, AdamW(lr=2e-3, weight_decay=1e-4,
                                               grad_clip=1.0))
            loss, grads = step.loss_and_grads(xb, yb)
            step.opt.update(grads, step.state, step.params)
            out[str(dev)] = ([loss, *grads], model.state_dict())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    (cpu_t, cpu_sd), (card_t, card_sd) = out["cpu"], out[str(cuda_device)]
    for i, (got, want) in enumerate(zip(card_t, cpu_t)):
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-5 * max(1.0, float(want.abs().max())), (i, err)
    for name, want in cpu_sd.items():
        got = card_sd[name].cpu()
        if want.dtype == torch.bool:
            assert torch.equal(got, want), name
            continue
        if bn and name.endswith(".b"):
            continue
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol, name


def test_trained_network_serves_identically_on_card(cuda_device):
    """JSC_DEMO trained on the card (100 steps), compiled and served by
    the three kernels: labels equal the CPU gather path's and the
    trained model's argmax on the card."""
    from repro_torch.configs.jsc import JSC_DEMO
    from repro_torch.data.jsc import train_test
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.mlp import mlp_forward, to_logic
    from repro_torch.serving.engine import LogicEngine
    from repro_torch.train.jsc_trainer import train_jsc
    data = train_test(4000, 1000)
    res = train_jsc(JSC_DEMO, steps=100, batch=128, data=data)
    assert next(res.model.parameters()).is_cuda
    net = to_logic(JSC_DEMO, res.model)
    x = data[1][0][:300]
    want = LogicEngine(net, 5, max_batch=128, device="cpu").classify(x)
    mlp = torch.argmax(mlp_forward(JSC_DEMO, res.model,
                                   torch.from_numpy(x).to(cuda_device))
                       [:, :5], dim=-1).cpu().numpy()
    np.testing.assert_array_equal(mlp, want)
    for backend, engine, kernel in (
            ("bitplane", "cuda-streamed", "lut_eval_streamed"),
            ("bitplane", "cuda", "lut_eval"), ("lut_layer", "numpy",
                                               "lut_layer")):
        eng = LogicEngine(net, 5, max_batch=128, backend=backend,
                          engine=engine, device=cuda_device)
        reset_launch_counts()
        np.testing.assert_array_equal(eng.classify(x), want)
        assert launch_counts()[kernel] > 0


def _seeded_jsc_s_net():
    """Full-width JSC-S from seeded weights, projected to its fanins."""
    from repro_torch.configs.jsc import JSC_S
    from repro_torch.models.mlp import final_masks, init_mlp, to_logic
    model = init_mlp(JSC_S, torch.Generator().manual_seed(0))
    model.set_masks(final_masks(JSC_S, model))
    return to_logic(JSC_S, model)


def test_kernelprof_on_the_served_plan_names_the_card(cuda_device):
    """The latency table of the served JSC-S plan: the synthetic grid
    and every level through the monolithic walk, every tile through the
    streamed walk, timed by CUDA events; rows finite and non-negative,
    both walks launched, the card named in ``meta``."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import build_latency_table
    from repro_torch.synth import compile_device_plan
    from repro_torch.synth.executor import BitplaneNetwork
    mapped = BitplaneNetwork.from_logic_network(
        _seeded_jsc_s_net(), engine="numpy", device="cpu").mapped
    dplan = compile_device_plan(mapped, tile_rows=32)
    reset_launch_counts()
    table = build_latency_table(dplan, iters=50, device=cuda_device)
    counts = launch_counts()
    assert counts["lut_eval"] > 0 and counts["lut_eval_streamed"] > 0
    plan = [r for r in table.rows if r["source"] == "plan"]
    tiles = [r for r in table.rows if r["source"] == "tile"]
    assert len(plan) == dplan.n_levels and len(tiles) == dplan.tiles.n_tiles
    for r in table.rows:
        assert np.isfinite(r["device_us"]) and r["device_us"] >= 0
        assert np.isfinite(r.get("prefix_us", 0.0))
    assert all(r["prefix_us"] > 0 for r in plan + tiles)
    assert table.meta["backend"] == "cuda"
    assert table.meta["device"] == torch.cuda.get_device_name(cuda_device)
    assert table.meta["power_limit"]
    assert table.estimate_plan_us(dplan) > 0


def test_autotune_sweep_on_the_card(cuda_device, tmp_path, monkeypatch):
    """The streamed walk's sweep over the seeded JSC-S plan at the
    serving batch (8 words): every candidate's plane bit-exact against
    the plain version at its tile_rows, every time positive, the winner
    persisted under the card's name and taken by an executor built
    without a spec, whose labels are ``classify``'s on the CPU."""
    from repro_torch.check import plan_fingerprint, preflight
    from repro_torch.kernels.lut_eval import autotune
    from repro_torch.synth.executor import (BitplaneNetwork,
                                            _CudaStreamedExecutor)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    net = _seeded_jsc_s_net()
    bn = BitplaneNetwork.from_logic_network(net, engine="cuda-streamed",
                                            device=cuda_device)
    x = np.random.default_rng(0).normal(size=(256, 16)).astype(np.float32)
    words = bn.pack_inputs(x)
    assert words.shape[1] == 8
    for tile_rows, block_w in autotune.DEFAULT_CANDIDATES:
        ex = _CudaStreamedExecutor(bn, spec=DEFAULT_SPEC.with_tile(
            tile_rows=tile_rows, block_w=block_w))
        launches = lut_eval_streamed.launches
        got = ex.plane(words)
        torch.cuda.synchronize()
        assert lut_eval_streamed.launches == launches + 1
        assert torch.equal(got, ex.plane(words, plain=True)), tile_rows
    timings = []
    best = autotune.autotune_streamed(bn, words, iters=20, timings=timings)
    assert len(timings) == len(autotune.DEFAULT_CANDIDATES)
    assert all(np.isfinite(t[2]) and t[2] > 0 for t in timings)
    assert best == min(timings, key=lambda t: t[2])
    dp = synth.compile_device_plan(bn.mapped, bn._plan)
    assert autotune.lookup(plan_fingerprint(dp),
                           torch.cuda.get_device_name(cuda_device)) == \
        best[:2]
    tuned = BitplaneNetwork(net, bn.mapped, engine="cuda-streamed",
                            device=cuda_device)
    ex = tuned.executor
    assert (ex.spec.tile.tile_rows, ex.spec.tile.block_w) == best[:2]
    want = BitplaneNetwork(net, bn.mapped, engine="numpy",
                           device="cpu").classify(x, 5)
    np.testing.assert_array_equal(tuned.classify(x, 5), want)
    rep = preflight(tuned)
    assert rep.ok and rep.info["tile_rows"] == best[0]


def test_corrupted_plan_is_refused_before_any_launch(cuda_device):
    """A leaf at the dump row, an output wire out of range or an INIT
    word other than 0 / ~0: ``compile_device_plan(verify=True)`` raises
    and the preflight of a network serving that plan fails, with no
    kernel launched."""
    import copy
    from repro_torch.check import CheckFailure, preflight
    from repro_torch.kernels import launch_counts
    from repro_torch.synth.executor import BitplaneNetwork
    bn = BitplaneNetwork.from_logic_network(
        _seeded_jsc_s_net(), engine="cuda", device=cuda_device)
    n_wires = 1 + bn.mapped.n_pis + bn.mapped.n_luts
    before = launch_counts()
    for code, corrupt in (
            ("leaf-range", lambda p: p.levels[0].leaf_idx.__setitem__(
                (0, 0), n_wires)),
            ("out-range", lambda p: p.levels[1].out_wires.__setitem__(
                0, n_wires + 5)),
            ("tt-encoding", lambda p: p.levels[0].tt_bits.__setitem__(
                (0, 0), 5))):
        bad = copy.copy(bn)
        bad._plan = copy.deepcopy(bn._plan)
        corrupt(bad._plan)
        with pytest.raises(CheckFailure) as ei:
            synth.compile_device_plan(bad.mapped, bad._plan, verify=True)
        assert code in {i.code for i in ei.value.report.errors}
        rep = preflight(bad)
        assert not rep.ok and code in {i.code for i in rep.errors}
    assert launch_counts() == before
    assert preflight(bn).ok


def test_two_streamed_replicas_under_the_scheduler_match_classify(
        cuda_device):
    """Seeded JSC-S on two ``cuda-streamed`` replicas behind the
    threaded scheduler (round robin, so both serve): every label equals
    the CPU gather path's."""
    from repro_torch.data.jsc import train_test
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import (MicroBatchScheduler, SchedConfig,
                                   build_logic_replicas)
    from repro_torch.serving.engine import LogicEngine
    net = _seeded_jsc_s_net()
    x = train_test()[1][0][:700]
    want = LogicEngine(net, 5, device="cpu").classify(x)
    rs = build_logic_replicas(net, 5, n_replicas=2, backend="bitplane",
                              policy="rr", engine="cuda-streamed",
                              device=cuda_device)
    s = MicroBatchScheduler(rs, SchedConfig(max_batch=256,
                                            max_wait_us=200.0))
    reset_launch_counts()
    s.start()
    futs = [s.submit(x[i]) for i in range(x.shape[0])]
    s.stop(drain=True)
    got = np.array([int(f.result(timeout=30)) for f in futs])
    np.testing.assert_array_equal(got, want)
    assert launch_counts()["lut_eval_streamed"] > 0
    assert all(r["served"] > 0 and r["failures"] == 0 for r in rs.stats())


@pytest.mark.parametrize("n_words", [1, 257])
def test_aig_sim_walk_and_route_match_plain(cuda_device, n_words):
    rng = np.random.default_rng(n_words)
    aig = synth.AIG(8)
    aig.outputs = [table_to_aig(aig, rng.random(256) < 0.5, None,
                                [2 * (i + 1) for i in range(8)])
                   for _ in range(3)]
    f0, f1 = aig.fanin_arrays()
    words = synth.random_words(8, n_words, seed=n_words)
    args = [_i32(a, cuda_device) for a in (words, f0, f1)]
    launches = aig_sim_walk.launches
    got = aig_sim_walk(*args)
    torch.cuda.synchronize()
    assert aig_sim_walk.launches == launches + 1
    assert torch.equal(got, aig_sim_ref(*args, 8))
    np.testing.assert_array_equal(
        aig_sim(words, f0, f1, 8, device=cuda_device),
        aig_sim(words, f0, f1, 8, device="cpu"))


def chain_literals(seed, n_pis, n_ands):
    """f0, f1 of ``n_ands`` AND nodes, each reading two random literals of
    earlier nodes (the constant and the inputs included)."""
    rng = np.random.default_rng(seed)
    hi = 2 * (1 + n_pis + np.arange(n_ands))
    return ((rng.random(n_ands) * hi).astype(np.int32),
            (rng.random(n_ands) * hi).astype(np.int32))


def forward_literals(seed, n_pis, n_ands):
    """f0, f1 of random literals anywhere in the plane: about half name
    the node itself or a later one, which read 0."""
    rng = np.random.default_rng(seed)
    n_rows = 1 + n_pis + n_ands
    return tuple(rng.integers(0, 2 * n_rows, n_ands).astype(np.int32)
                 for _ in range(2))


def strict_chain(seed, n_pis, n_ands):
    """Node i ANDs node i - 1 (the last input for node 0) with a random
    earlier literal: depth n_ands, but values that settle early."""
    rng = np.random.default_rng(seed)
    prev = 2 * (n_pis + np.arange(n_ands)) + rng.integers(0, 2, n_ands)
    hi = 2 * (1 + n_pis + np.arange(n_ands))
    return prev.astype(np.int32), (rng.random(n_ands) * hi).astype(np.int32)


def toggling_chain(n_pis, n_ands):
    """Node i is NOT node i - 1 (the last input for node 0), ANDed with
    the constant 1: every sweep before the n_ands-th changes a row."""
    prev = 2 * (n_pis + np.arange(n_ands)) + 1
    return prev.astype(np.int32), np.ones(n_ands, np.int32)


def _walk_check(device, f0, f1, n_pis, n_words):
    """The walk on the card against its plain version (on the CPU), bit
    for bit; returns the plan it ran."""
    words = synth.random_words(n_pis, n_words, seed=n_words)
    host = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
            for a in (words, f0, f1)]
    launches = aig_sim_walk.launches
    got = aig_sim_walk(*(t.to(device) for t in host))
    torch.cuda.synchronize()
    assert aig_sim_walk.launches == launches + 1
    assert torch.equal(got.cpu(), aig_sim_ref(*host, n_pis))
    return plan_walk(n_pis, len(f0), n_words)


@pytest.mark.parametrize("n_words", [7, 200])
def test_aig_sim_walk_from_device_memory(cuda_device, n_words):
    """A 60,000-AND plane (60,017 rows) does not fit shared memory even
    one word wide: the sweeps alternate between the output and a
    scratch plane in device memory."""
    f0, f1 = chain_literals(n_words, 16, 60_000)
    assert not _walk_check(cuda_device, f0, f1, 16, n_words)[1]


@pytest.mark.parametrize("n_words,tw", [
    (1, 1), (3, 1), (254, 1), (255, 2), (256, 2), (508, 2), (509, 4),
    (511, 4), (1026, 4)])
def test_aig_sim_walk_at_tile_edges(cuda_device, n_words, tw):
    """The bench-sized AIG (8 inputs, about 600 ANDs) at W on either
    side of each word-tile width's threshold and with ragged last
    tiles."""
    rng = np.random.default_rng(n_words)
    aig = synth.AIG(8)
    aig.outputs = [table_to_aig(aig, rng.random(256) < 0.5, None,
                                [2 * (i + 1) for i in range(8)])
                   for _ in range(4)]
    f0, f1 = aig.fanin_arrays()
    assert _walk_check(cuda_device, f0, f1, 8, n_words) == (tw, True)


@pytest.mark.parametrize("n_words", [1, 33])
@pytest.mark.parametrize("n_ands", [40, 3000])
def test_aig_sim_walk_forward_literals_read_zero(cuda_device, n_words,
                                                 n_ands):
    """Literals of the node itself or a later one read 0 (then the
    complement), as in the plain version, and do not hang the card."""
    f0, f1 = forward_literals(n_ands, 5, n_ands)
    _walk_check(cuda_device, f0, f1, 5, n_words)


@pytest.mark.parametrize("n_words", [1, 200])
def test_aig_sim_walk_strict_chain(cuda_device, n_words):
    """A chain of 2,500 ANDs, depth 2,500, each node ANDed with a random
    earlier literal: its values settle long before its end, so the
    sweeps stop early."""
    f0, f1 = strict_chain(n_words, 16, 2500)
    _walk_check(cuda_device, f0, f1, 16, n_words)


@pytest.mark.parametrize("n_ands,n_words,in_smem", [
    (2500, 1, True), (2500, 200, True), (60_000, 3, False)])
def test_aig_sim_walk_toggling_chain(cuda_device, n_ands, n_words, in_smem):
    """A chain of inverters, depth n_ands, whose values change in every
    sweep: the sweeps reach their cap and the block finishes the walk in
    node order, with the planes in shared and in device memory."""
    f0, f1 = toggling_chain(16, n_ands)
    assert n_ands > max_sweeps(n_ands)
    assert _walk_check(cuda_device, f0, f1, 16, n_words)[1] == in_smem


XNOR_SHAPES = [(256, 4096, 256), (37, 100, 70), (17, 257, 9),
               (33, 1000, 65), (64, 4096, 24), (1, 7, 1), (300, 1000, 33)]


@pytest.mark.parametrize("B,n,N", XNOR_SHAPES)
def test_xnor_kernel_matches_plain(cuda_device, B, n, N):
    """The bench shape and shapes that cross the kernel's 32 x 16 output
    tiles, its 16-word slabs and a word (pad bits), with zeros (which
    pack as -1); rows of a multiple of 4 words load as 16-byte vectors,
    the others word by word."""
    rng = np.random.default_rng(B)
    x, w = (torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], s)
                             .astype(np.float32)).to(cuda_device)
            for s in ((B, n), (N, n)))
    xp, wp = pack_bipolar(x), pack_bipolar(w)
    assert loads_vectorized(xp, wp) == (xp.shape[1] % 4 == 0)
    launches = xnor_matmul_packed.launches
    got = xnor_matmul_packed(xp, wp, n)
    torch.cuda.synchronize()
    assert xnor_matmul_packed.launches == launches + 1
    assert torch.equal(got, xnor_popcount_ref(xp, wp, n))


@pytest.mark.parametrize("B,n,N", [(33, 1000, 65), (64, 4000, 24)])
def test_xnor_kernel_counts_every_bit_as_the_plain_version(cuda_device, B, n,
                                                           N):
    """Packed words with their pad bits set (outside ``pack_bipolar``'s
    contract): the kernel counts every bit of every word, as the plain
    version does."""
    rng = np.random.default_rng(n)
    xp, wp = (torch.from_numpy(rng.integers(0, 1 << 32, (r, -(-n // 32)),
                                            dtype=np.uint32).view(np.int32))
              .to(cuda_device) for r in (B, N))
    got = xnor_matmul_packed(xp, wp, n)
    torch.cuda.synchronize()
    assert torch.equal(got, xnor_popcount_ref(xp, wp, n))


def fanin_operands(B, n_in, N, K, dtype, device, seed=0):
    """Seeded operands in ``dtype``; a third of the indices shifted into
    [-n_in, 0) (they wrap) and, where N allows, four out of range
    (n_in, -n_in - 1, 2^30, -2^31: NaN outputs)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_in, (N, K)).astype(np.int32)
    idx[::3] -= n_in
    if N >= 8 and K > 0:
        rows = rng.choice(N, size=4, replace=False)
        idx[rows, rng.integers(0, K, 4)] = [n_in, -n_in - 1, 1 << 30,
                                            -(1 << 31)]
    x, w, bias = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  .to(device=device, dtype=dtype)
                  for s in ((B, n_in), (N, K), (N,)))
    return x, torch.from_numpy(idx).to(device), w, bias


def equal_with_nans(got, want):
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], want[~nan]))


FANIN_TYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", FANIN_TYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("B,n_in,N,K", [
    (256, 4096, 1024, 8),     # the bench shape: rows staged, 2 a block
    (70, 33, 45, 3),          # ragged, one row a block
    (8, 4096, 1024, 8),       # a short batch: neurons over 16 blocks
    (129, 1001, 257, 13),     # odd row bytes in 2-byte types, K > 8
    (513, 2000, 3000, 5),     # 2 rows a block, 3 neurons a thread
    (5, 60_000, 70, 9),       # float32 rows too wide to stage
    (3, 120_000, 40, 4),      # no type's rows staged
])
def test_fanin_kernel_matches_plain(cuda_device, dtype, B, n_in, N, K):
    """Bit for bit, NaN positions included, on each branch of
    ``plan_fanin`` (rows in shared memory or in device memory)."""
    from repro_torch.kernels.fanin_matmul.ops import (plan_fanin,
                                                      staged_bytes)
    x, idx, w, bias = fanin_operands(B, n_in, N, K, dtype, cuda_device, N)
    plan = plan_fanin(B, n_in, N, dtype)
    assert plan.staged == (staged_bytes(1, n_in, dtype)
                           <= DEFAULT_SPEC.tile.smem_budget_bytes)
    launches = fanin_matmul.launches
    got = fanin_matmul(x, idx, w, bias)
    torch.cuda.synchronize()
    assert fanin_matmul.launches == launches + 1
    assert got.dtype == dtype
    want = fanin_matmul_ref(x, idx, w, bias)
    assert torch.isnan(want).any() == (N >= 8 and K > 0)
    assert equal_with_nans(got, want)


def test_fanin_kernel_takes_any_k(cuda_device):
    """K of 0, 1 and 300 (many chunks of eight, a ragged last one): the
    indices and weights pass through registers, so nothing limits K."""
    for K in (0, 1, 300):
        x, idx, w, bias = fanin_operands(9, 500, 37, K, torch.float32,
                                         cuda_device, K)
        got = fanin_matmul(x, idx, w, bias)
        torch.cuda.synchronize()
        assert equal_with_nans(got, fanin_matmul_ref(x, idx, w, bias))


def test_fanin_kernel_staged_rows_keep_their_alignment(cuda_device):
    """x starting 2, 4 and 6 bytes past a 16-byte boundary, in bfloat16
    and float16: the staged copy keeps the address mod 16."""
    for dtype in (torch.bfloat16, torch.float16):
        x, idx, w, bias = fanin_operands(7, 301, 50, 6, dtype, cuda_device)
        buf = torch.empty(x.numel() + 8, dtype=dtype, device=cuda_device)
        for off in (1, 2, 3):
            xv = buf[off: off + x.numel()].view(x.shape)
            xv.copy_(x)
            got = fanin_matmul(xv, idx, w, bias)
            torch.cuda.synchronize()
            assert equal_with_nans(got, fanin_matmul_ref(x, idx, w, bias))


FLASH_SHAPES = [
    (1, 1024, 1024, 4, 2, 64, True, 0),   # the bench shape
    (2, 100, 77, 4, 1, 32, True, 24),     # window, ragged S
    (1, 200, 300, 2, 2, 8, False, 0),     # dh 8 -> the 16 template
    (1, 130, 130, 2, 1, 100, True, 0),    # dh 100 -> 128, ragged dh
    (1, 70, 90, 2, 1, 128, False, 40),    # dh 128, window only
    (1, 300, 130, 1, 1, 8, True, 4),      # fully masked rows
    (1, 65, 200, 3, 1, 6, True, 0),       # 8-byte copies (f32, bf16 4)
    (1, 65, 200, 3, 3, 5, False, 0),      # 4-byte copies (bf16 2)
    (1, 65, 200, 2, 1, 7, True, 9),       # odd dh
    (1, 65, 200, 2, 1, 12, True, 0),      # bf16 8-byte copies
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,win", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda_device, b, sq, sk, h, kv, dh,
                                    causal, win, dtype, tol):
    """Every dh template, copy width and mask, in float32 (three TF32
    passes, held at 2e-4 against the plain version in full float32) and
    bfloat16 (held at the reference's 2e-2); every block merges its four
    warps' key slices."""
    rng = np.random.default_rng(sq + dh)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(cuda_device, dtype) for s in (
                   (b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)))
    launches = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    assert got.dtype == dtype and got.shape == q.shape
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = attention_ref(q, k, v, causal=causal, window=win)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    assert (got.float() - want.float()).abs().max().item() <= tol


# the flash backward: the gradient of the training forward's attention

FLASH_BWD_SHAPES = [
    # b, sq, sk, h, kv, dh, causal, window, dtype
    (4, 1024, 1024, 32, 2, 128, True, 0, torch.bfloat16),  # glm4-9b train
    (2, 256, 256, 8, 2, 128, True, 0, torch.float32),      # float32, dh 128
    (2, 128, 128, 4, 2, 16, True, 64, torch.bfloat16),     # mixtral smoke
    (2, 128, 128, 4, 2, 16, True, 64, torch.float32),
    (2, 64, 8, 4, 4, 16, False, 0, torch.bfloat16),        # seamless cross
    (2, 64, 8, 4, 4, 16, False, 0, torch.float32),
    (1, 100, 100, 4, 2, 64, True, 0, torch.bfloat16),      # ragged S
    (1, 100, 100, 4, 2, 64, True, 0, torch.float32),
    (1, 70, 90, 2, 1, 100, False, 40, torch.float32),      # window only
    (1, 300, 130, 2, 1, 8, True, 4, torch.float32),        # fully masked rows
    (1, 300, 130, 2, 1, 8, False, 4, torch.bfloat16),
    (1, 65, 200, 3, 1, 7, True, 9, torch.bfloat16),        # odd dh
    (4, 1024, 1024, 16, 1, 128, True, 0, torch.bfloat16),  # tensor-parallel
    (2, 256, 256, 8, 1, 64, True, 0, torch.bfloat16),      # group of 8, dh 64
    (2, 160, 200, 4, 2, 128, False, 0, torch.bfloat16),    # Sk 200, Sq 160
    (1, 200, 200, 6, 2, 64, True, 0, torch.bfloat16),      # odd group of 3
    (2, 256, 256, 8, 2, 128, True, 64, torch.bfloat16),    # windowed GQA
    # the wgmma branch's twins of the window-only, fully masked and causal
    # Sq != Sk cases above
    (1, 300, 130, 2, 1, 64, True, 4, torch.bfloat16),      # fully masked rows
    (1, 300, 130, 2, 1, 128, False, 4, torch.bfloat16),
    (1, 70, 90, 2, 1, 128, False, 40, torch.bfloat16),     # window only
    (1, 65, 200, 3, 1, 64, True, 0, torch.bfloat16),       # causal, Sq < Sk
]
FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def _plain_grads(q, k, v, dout, causal, window):
    """Autograd through ``attention_ref`` in full float32 (TF32 off)."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return attention_backward_ref(q, k, v, dout, causal=causal,
                                      window=window)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


def _grads_close(got, want, dtype):
    """Each gradient within the forward's tolerance x max(1, max |plain|)."""
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        scale = max(1.0, b.float().abs().max().item())
        err = (a.float() - b.float()).abs().max().item()
        assert err <= FLASH_TOL[dtype] * scale, (name, err, scale)


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,win,dtype", FLASH_BWD_SHAPES)
def test_flash_backward_kernel_matches_plain(cuda_device, b, sq, sk, h, kv,
                                             dh, causal, win, dtype):
    """The backward kernel's dq, dk, dv against autograd through
    ``attention_ref``, at the training path's shapes (glm4-9b's, the
    mixtral smoke's windowed GQA, the seamless smoke's cross-attention)
    and ragged, window-only, fully masked and odd-dh ones; one launch."""
    rng = np.random.default_rng(sq + dh + h)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(cuda_device, dtype) for s in (
                   (b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)))
    dout = torch.from_numpy(rng.normal(size=(b, sq, h, dh)).astype(
        np.float32)).to(cuda_device, dtype)
    out, lse = flash_attention_forward(q, k, v, causal=causal, window=win)
    launches = flash_attention_backward.launches
    branches = dict(flash_attention_backward.branches)
    got = flash_attention_backward(q, k, v, out, dout, lse, causal=causal,
                                   window=win)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches == launches + 1
    branch = _backward_branch(dtype, dh)
    assert flash_attention_backward.branches[branch] == \
        branches.get(branch, 0) + 1
    _grads_close(got, _plain_grads(q, k, v, dout, causal, win), dtype)


def _backward_branch(dtype, dh) -> str:
    """The backward kernel's branch for these (aligned) operands."""
    return "wgmma" if dtype == torch.bfloat16 and dh in (64, 128) else "mma"


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,win", [
    (4, 1024, 1024, 32, 2, 128, True, 0), (2, 160, 200, 4, 2, 64, False, 0),
    (1, 200, 200, 6, 2, 64, True, 0), (1, 300, 130, 2, 1, 64, True, 4)])
def test_flash_backward_dk_dv_are_deterministic(cuda_device, b, sq, sk, h,
                                                kv, dh, causal, win):
    """Two launches of the wgmma backward on the same inputs give dk and
    dv bit for bit (the group's float32 partials are summed in a fixed
    order); dq, summed by atomics, within the tolerance of each other."""
    rng = np.random.default_rng(sq + dh + h)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(cuda_device, torch.bfloat16) for s in (
                   (b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)))
    dout = torch.from_numpy(rng.normal(size=(b, sq, h, dh)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    out, lse = flash_attention_forward(q, k, v, causal=causal, window=win)
    wgmma = flash_attention_backward.branches["wgmma"]
    first = flash_attention_backward(q, k, v, out, dout, lse, causal=causal,
                                     window=win)
    second = flash_attention_backward(q, k, v, out, dout, lse, causal=causal,
                                      window=win)
    torch.cuda.synchronize()
    assert flash_attention_backward.branches["wgmma"] == wgmma + 2
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[2], second[2])
    scale = max(1.0, first[0].float().abs().max().item())
    assert (first[0].float() - second[0].float()).abs().max().item() <= \
        FLASH_TOL[torch.bfloat16] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,win", [
    (1, 1024, 1024, 4, 2, 64, True, 0), (1, 300, 130, 2, 1, 8, True, 4),
    (2, 64, 8, 4, 4, 16, False, 0), (2, 100, 77, 4, 1, 32, True, 24)])
def test_flash_forward_with_lse_is_unchanged(cuda_device, b, sq, sk, h, kv,
                                             dh, causal, win, dtype):
    """Asking the forward for its log-sum-exp leaves its output bit for
    bit as the serving launch gives it; the log-sum-exp is the plain
    version's within 1e-4 (x max(1, |lse|)), +inf on fully masked rows."""
    rng = np.random.default_rng(sq + dh)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(cuda_device, dtype) for s in (
                   (b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)))
    want = flash_attention(q, k, v, causal=causal, window=win)
    out, lse = flash_attention_forward(q, k, v, causal=causal, window=win)
    assert torch.equal(out, want)
    ref = attention_lse_ref(q, k, causal=causal, window=win)
    assert torch.equal(torch.isinf(lse), torch.isinf(ref))
    fin = torch.isfinite(ref)
    assert ((lse[fin] - ref[fin]).abs() / ref[fin].abs().clamp(min=1)
            ).max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_gradients_on_card_match_plain(cuda_device, dtype):
    """``layers.attention`` on the card under autograd: the forward and
    backward kernels launch once each and q, k, v get the plain
    version's gradients (the forward used to allocate its output outside
    autograd, so q, k and v got none)."""
    from repro_torch.models import layers as L
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(cuda_device, dtype).requires_grad_(True)
               for s in ((2, 96, 4, 32), (2, 96, 2, 32), (2, 96, 2, 32)))
    dout = torch.from_numpy(rng.normal(size=(2, 96, 4, 32)).astype(
        np.float32)).to(cuda_device, dtype)
    fwd, bwd = flash_attention.launches, flash_attention_backward.launches
    out = L.attention(q, k, v, causal=True, window=40)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert flash_attention.launches == fwd + 1
    assert flash_attention_backward.launches == bwd + 1
    _grads_close(got, _plain_grads(q.detach(), k.detach(), v.detach(), dout,
                                   True, 40), dtype)


def test_lm_forward_under_grad_reaches_wq_wk_wv(cuda_device):
    """The glm4 smoke's loss on the card: every layer's wq, wk and wv
    get a non-zero gradient through the flash kernels (2 forward
    launches a layer, the block's recomputation included, and 1
    backward)."""
    from repro_torch.configs import SMOKES
    from repro_torch.models import lm
    from repro_torch.train import loop
    cfg = SMOKES["glm4-9b"]
    params = lm.init_params(cfg, torch.Generator(device=cuda_device)
                            .manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 65)).astype(np.int32)).to(cuda_device)
    fwd, bwd = flash_attention.launches, flash_attention_backward.launches
    _, grads = loop.loss_and_grads(cfg, params, {"tokens": toks[:, :-1],
                                                 "labels": toks[:, 1:]})
    torch.cuda.synchronize()
    assert flash_attention.launches == fwd + 2 * cfg.n_layers
    assert flash_attention_backward.launches == bwd + cfg.n_layers
    named = dict(zip(lm.leaf_names(params), grads))
    for i in range(cfg.n_layers):
        for w in ("wq", "wk", "wv"):
            g = named[f"layers::{i}::attn::{w}"]
            assert torch.isfinite(g).all() and g.abs().max() > 0, (i, w)


# the LM stack: prefill attention through the flash kernel

@pytest.mark.parametrize("name", ["glm4-9b", "hymba-1.5b"])
def test_lm_attention_mixer_runs_the_flash_kernel(cuda_device, name):
    """``_attention_mixer`` at smoke width (bf16) on the card launches the
    flash kernel once and agrees with its CPU twin (``full_attention``):
    the kernel is within 2e-2 of the plain attention, which ``wo`` carries
    to each output at most 2e-2 x its column's L1 norm, plus bf16
    rounding of the products (2^-6 x max |y|); k and v are the same
    products on both devices."""
    import copy

    from repro_torch.configs import SMOKES
    from repro_torch.models import lm
    cfg = SMOKES[name]
    attn = lm.init_params(cfg, torch.Generator().manual_seed(0)).layers[0].attn
    x = torch.randn((2, 80, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    pos = torch.arange(80)
    want, (k, v) = lm._attention_mixer(cfg, attn, x, pos, window=cfg.window)
    launches = flash_attention.launches
    got, (kc, vc) = lm._attention_mixer(
        cfg, copy.deepcopy(attn).to(cuda_device), x.to(cuda_device),
        pos.to(cuda_device), window=cfg.window)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    wo = attn.wo.to(torch.bfloat16).float()
    tol = (2e-2 * wo.abs().sum(0).max() + 2.0 ** -6 * want.float().abs().max())
    assert (got.cpu().float() - want.float()).abs().max() <= tol
    for a, b in ((kc, k), (vc, v)):
        assert (a.cpu().float() - b.float()).abs().max() <= \
            2.0 ** -7 * b.float().abs().max()


def test_lm_attention_refuses_dh_over_128_on_the_card(cuda_device):
    """dh 192 (nemotron-4-340b's) raises on the card instead of running a
    plain version."""
    import dataclasses

    from repro_torch.configs import SMOKES
    from repro_torch.models import lm
    cfg = dataclasses.replace(SMOKES["glm4-9b"], d_head=192)
    attn = lm.init_params(cfg, torch.Generator(device=cuda_device)
                          .manual_seed(0)).layers[0].attn
    x = torch.zeros((1, 4, cfg.d_model), device=cuda_device,
                    dtype=torch.bfloat16)
    launches = flash_attention.launches
    with pytest.raises(ValueError, match="dh"):
        lm._attention_mixer(cfg, attn, x, torch.arange(4, device=cuda_device))
    assert flash_attention.launches == launches


@pytest.mark.parametrize("name", ["glm4-9b", "mixtral-8x22b"])
def test_lm_engine_on_card_matches_single_request(cuda_device, name):
    """``LMEngine`` on the card gives a single-request greedy loop's
    tokens; where a batch of slots and a batch of one part, the loop's
    logit for the engine's token lies within four bf16 steps of its top
    (4 x 2^-7 |top|): products of a batch of slots and of a batch of one
    round in other orders. The loop then takes the engine's token and
    goes on comparing to the last token."""
    from repro_torch.configs import SMOKES
    from repro_torch.models import lm
    from repro_torch.serving.engine import LMEngine, LMRequest
    cfg = SMOKES[name]
    params = lm.init_params(cfg, torch.Generator(device=cuda_device)
                            .manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 16, dtype=np.int32)
               for _ in range(3)]
    launches = flash_attention.launches
    eng = LMEngine(cfg, params, n_slots=2, max_seq=64, device=cuda_device)
    reqs = [LMRequest(prompt=p, max_new_tokens=6) for p in prompts]
    done = eng.run(reqs)
    assert len(done) == 3
    assert flash_attention.launches == launches + 3 * cfg.n_layers

    for req in reqs:
        with torch.inference_mode():
            logits, cache = lm.prefill(
                cfg, params, torch.as_tensor(req.prompt[None],
                                             device=cuda_device), max_seq=64)
            pos = len(req.prompt)
            for i, tok in enumerate(req.out_tokens):
                row = logits[0].float()
                top = float(row.max())
                if int(torch.argmax(row)) != tok:
                    assert top - float(row[tok]) <= 4 * 2.0 ** -7 * abs(top), \
                        (i, tok, top, float(row[tok]))
                logits, cache = lm.decode_step(
                    cfg, params, cache,
                    torch.tensor([[tok]], dtype=torch.int32,
                                 device=cuda_device),
                    torch.tensor([pos], dtype=torch.int32,
                                 device=cuda_device))
                pos += 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_moe_on_card_matches_cpu(cuda_device, dtype):
    """The MoE layer on the card against the CPU on the same weights and
    tokens, with drops (capacity factor 0.5) and k = 4: float32 within
    1e-5 x max(1, |cpu|), bf16 within four bf16 steps of the output's
    scale (the card's products round in another order); routing never
    synchronizes the host (sync debug mode raises on one)."""
    import dataclasses

    from repro_torch.configs import SMOKES
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    for kw in ({"capacity_factor": 0.5}, {"n_experts": 8, "moe_top_k": 4}):
        cfg = dataclasses.replace(SMOKES["dbrx-132b"], **kw)
        p = lm.Params(L.init_moe(torch.Generator().manual_seed(0), cfg))
        x = torch.randn((3, 24, cfg.d_model),
                        generator=torch.Generator().manual_seed(1)).to(dtype)
        want = L.moe(x, p, cfg).float()
        pc, xc = p.to(cuda_device), x.to(cuda_device)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = L.moe(xc, pc, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got = got.float().cpu()
        if dtype == torch.float32:
            assert ((got - want).abs() / want.abs().clamp(min=1)).max() \
                <= 1e-5
        else:
            assert (got - want).abs().max() <= \
                4 * 2.0 ** -7 * want.abs().max()


def test_lm_encdec_on_card_runs_the_flash_kernel(cuda_device):
    """The seamless smoke on the card: prefill over frame embeddings
    launches the flash kernel for the encoder, the decoder and the
    cross-attention of every layer, and a decode step once a layer for
    its cross-attention (Sq 1 over the frames); the logits agree with
    the CPU's within four bf16 steps of their scale."""
    from repro_torch.configs import SMOKES
    from repro_torch.models import lm
    cfg = SMOKES["seamless-m4t-large-v2"]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 25)).astype(np.int32))
    enc = (torch.randn((2, 12, cfg.d_model),
                       generator=torch.Generator().manual_seed(3))
           * 0.1).bfloat16()
    pos = torch.full((2,), 24, dtype=torch.int32)
    outs = []
    for dev in ("cpu", cuda_device):
        p = params.to(dev) if dev != "cpu" else params
        with torch.inference_mode():
            launches = flash_attention.launches
            logits, cache = lm.prefill(cfg, p, toks[:, :24].to(dev),
                                       enc_embeds=enc.to(dev), max_seq=32)
            n_prefill = flash_attention.launches - launches
            step, _ = lm.decode_step(cfg, p, cache, toks[:, 24:].to(dev),
                                     pos.to(dev))
            n_step = flash_attention.launches - launches - n_prefill
        outs.append((logits.float().cpu(), step.float().cpu(), n_prefill,
                     n_step))
    (cl, cs, _, _), (gl, gs, n_prefill, n_step) = outs
    assert n_prefill == cfg.n_enc_layers + 2 * cfg.n_layers
    assert n_step == cfg.n_layers
    for got, want in ((gl, cl), (gs, cs)):
        assert (got - want).abs().max() <= 4 * 2.0 ** -7 * want.abs().max()


def test_entry_points_without_a_card_raise():
    """Without a card, the kernel bench and the device route of
    ``simulate`` called without ``device=`` raise instead of running on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.bench.kernels_bench import run
    with pytest.raises(NoCudaDeviceError):
        run()
    aig = synth.AIG(2)
    aig.outputs = [aig.and2(2, 4)]
    with pytest.raises(NoCudaDeviceError):
        synth.simulate(aig, synth.random_words(2, 1), use_kernel=True)


# ---------------------------------------------------------------------------
# Placement on the card (repro_torch.dist): world 1 over NCCL, and two
# ranks sharing the card over gloo
# ---------------------------------------------------------------------------

DIST_TOL = 1e-5        # placed against unplaced, float32


def _dist_jobs(shape):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.dist import checks
    from repro_torch.models import lm
    rng = np.random.default_rng(1)

    def cfg(name, **kw):
        return dataclasses.replace(get_arch(name, smoke=True),
                                   compute_dtype="float32", **kw)

    def params(c):
        return checks.stacked_numpy(lm.init_params(
            c, torch.Generator().manual_seed(0)))

    glm, glm4, phi = cfg("glm4-9b"), cfg("glm4-9b", n_layers=4), \
        cfg("phi4-mini-3.8b")
    return [("fsdp", "fsdp", dict(cfg=phi, params_np=params(phi),
                                  toks_np=rng.integers(0, 512, (8, 64)).astype(
                                      np.int32), shape=shape,
                                  device="cuda")),
            ("decode", "decode", dict(cfg=glm, params_np=params(glm),
                                      toks_np=rng.integers(0, 512, (4, 33))
                                      .astype(np.int32), shape=shape,
                                      device="cuda", prompt=32, max_seq=40)),
            ("pipeline", "pipeline", dict(cfg=glm4, params_np=params(glm4),
                                          toks_np=rng.integers(
                                              0, 512, (4, 32)).astype(
                                              np.int32), shape=shape,
                                          device="cuda"))]


def _dist_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def test_dist_checks_at_world_one_on_card(cuda_device):
    """fsdp_pure, serve_tp_only decode and the pipeline on a (1, 1) mesh
    over NCCL: placed within DIST_TOL of unplaced, TF32 off."""
    from repro_torch.dist import checks, world
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        (res,) = world.run(checks.run_checks, 1, (_dist_jobs((1, 1)),),
                           backend="nccl", device="cuda", timeout=300)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for label, r in res.items():
        assert "error" not in r, r["error"]
        if label == "fsdp":
            pairs = list(zip(r["placed"][2], r["unplaced"][2])) + [
                (r["placed"][i], r["unplaced"][i]) for i in (0, 1)]
        else:
            pairs = [(r["placed"], r["unplaced"])] + list(zip(
                r.get("grads_placed", []), r.get("grads_unplaced", [])))
        assert max(_dist_err(a, b) for a, b in pairs) <= DIST_TOL, label
    assert res["decode"]["counts"].get("decode_heads", 0) > 0


def test_dist_pipeline_two_ranks_share_the_card(cuda_device):
    """GPipe over two stages with both ranks on one card (gloo): hidden
    states and gradients within DIST_TOL of the unplaced forward."""
    from repro_torch.dist import checks, world
    job = [j for j in _dist_jobs((1, 2)) if j[0] == "pipeline"]
    for res in world.run(checks.run_checks, 2, (job,), backend="gloo",
                         device="cuda", timeout=300):
        r = res["pipeline"]
        assert "error" not in r, r["error"]
        assert r["counts"] == {"pipeline": 1}
        for a, b in [(r["placed"], r["unplaced"])] + list(zip(
                r["grads_placed"], r["grads_unplaced"])):
            assert _dist_err(a, b) <= DIST_TOL


def test_launcher_model_par_1_on_card_matches_unplaced(cuda_device):
    """``launch.train --model-par 1`` (NCCL world 1) against the
    launcher without a mesh flag, glm4 smoke, three steps."""
    from repro_torch.dist import checks, world
    from repro_torch.launch.train import main
    argv = ["--arch", "glm4-9b", "--smoke", "--steps", "3", "--batch", "4",
            "--seq", "64", "--log-every", "1"]
    want = main(list(argv))
    (res,) = world.run(checks.run_checks, 1, ([(
        "launch", "launcher", {"argv": argv + ["--model-par", "1"]})],),
        backend="nccl", device="cuda", timeout=300)
    got = res["launch"]
    assert "error" not in got, got["error"]
    for key in ("loss", "grad_norm"):
        assert abs(got[key] - want[key]) <= 4 * 2.0 ** -7 * max(
            1.0, abs(want[key])), (key, got[key], want[key])
