"""The whole slice on the CPU: reference JSC-S weights carried into the
port, compiled to the same truth tables and the same mapped 6-LUT
netlist, and served argmax-identically to the reference's gather
backend by every port backend and engine (the kernels' plain versions),
over a 600-row stream whose last flush is ragged (600 = 4*128 + 88)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.jsc import JSC_S as REF_JSC_S
from repro.data.jsc import train_test as ref_train_test
from repro.models import mlp as ref_mlp
from repro.serving.engine import LogicEngine as RefLogicEngine
from repro.synth import compile_logic_network as ref_compile_logic_network
from repro_torch.configs.jsc import JSC_S
from repro_torch.data.jsc import train_test
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve as launch_serve
from repro_torch.models.mlp import final_masks, mlp_forward, to_logic
from repro_torch.serving.engine import LogicEngine
from repro_torch.synth import BitplaneNetwork, compile_logic_network
from repro_torch.weights import (load_params_npz, params_from_jax,
                                 save_params_npz)

N_ROWS = 600


def _reference_state():
    """Reference JSC-S at init, with biases, ranges and BN perturbed so
    that folding and learned ranges matter; masks from the reference."""
    params = ref_mlp.init_mlp_params(REF_JSC_S, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(11)
    bn = {"mean": [], "var": []}
    for lp in params["layers"]:
        n = lp["b"].shape[0]
        lp["b"] = rng.normal(scale=0.2, size=n).astype(np.float32)
        lp["alpha"] = np.float32(rng.uniform(0.7, 1.5))
        lp["bn_gamma"] = rng.uniform(0.6, 1.4, n).astype(np.float32)
        lp["bn_beta"] = rng.normal(scale=0.2, size=n).astype(np.float32)
        bn["mean"].append(rng.normal(scale=0.2, size=n).astype(np.float32))
        bn["var"].append(rng.uniform(0.5, 2.0, n).astype(np.float32))
    masks = [np.asarray(m) for m in ref_mlp.final_masks(REF_JSC_S, params)]
    return params, masks, bn


@pytest.fixture(scope="module")
def slice_state(tmp_path_factory):
    params, masks, bn = _reference_state()
    ref_net = ref_mlp.to_logic(
        REF_JSC_S, jax.tree.map(jnp.asarray, params),
        [jnp.asarray(m) for m in masks], jax.tree.map(jnp.asarray, bn))
    path = tmp_path_factory.mktemp("weights") / "jsc_s.npz"
    save_params_npz(path, params_from_jax(params, masks, bn))
    model = load_params_npz(path)
    net = to_logic(JSC_S, model)
    (_, _), (xte, yte) = train_test()
    want = RefLogicEngine(ref_net, 5, max_batch=128).classify(xte[:N_ROWS])
    return dict(params=params, masks=masks, bn=bn, ref_net=ref_net,
                model=model, net=net, xte=xte, yte=yte, want=want, path=path)


def test_weights_round_trip(slice_state):
    params, masks, bn = (slice_state[k] for k in ("params", "masks", "bn"))
    model = slice_state["model"]
    for i, (layer, lp) in enumerate(zip(model.layers, params["layers"])):
        for name in ("w", "b", "alpha", "bn_gamma", "bn_beta"):
            np.testing.assert_array_equal(
                getattr(layer, name).detach().numpy(), lp[name])
        np.testing.assert_array_equal(layer.mask.numpy(), masks[i])
        np.testing.assert_array_equal(layer.bn_mean.numpy(), bn["mean"][i])
        np.testing.assert_array_equal(layer.bn_var.numpy(), bn["var"][i])
    # the port's FCP masks of the same weights are the reference's
    for got, want in zip(final_masks(JSC_S, model), masks):
        np.testing.assert_array_equal(got.numpy(), want)


def test_data_and_tables_match_reference(slice_state):
    (_, _), (rx, ry) = ref_train_test()
    np.testing.assert_array_equal(slice_state["xte"], rx)
    np.testing.assert_array_equal(slice_state["yte"], ry)
    ref_net, net = slice_state["ref_net"], slice_state["net"]
    assert len(net.layers) == len(ref_net.layers)
    for got, want in zip(net.layers, ref_net.layers):
        np.testing.assert_array_equal(got.fanin_idx, want.fanin_idx)
        np.testing.assert_array_equal(got.tables, want.tables)
        assert (got.in_alpha, got.out_alpha) == (want.in_alpha,
                                                 want.out_alpha)


def test_mapped_netlist_matches_reference(slice_state):
    ref = ref_compile_logic_network(slice_state["ref_net"]).mapped
    got = compile_logic_network(slice_state["net"], device="cpu").mapped
    assert got.n_luts == ref.n_luts and got.depth == ref.depth
    assert (got.n_pis, got.k, got.outputs) == (ref.n_pis, ref.k, ref.outputs)
    assert [(l.root, l.leaves, l.tt) for l in got.luts] == \
        [(l.root, l.leaves, l.tt) for l in ref.luts]
    # every engine over that netlist: codes, values and labels as the
    # reference's network gives them (full and ragged lane words)
    ref_net = slice_state["ref_net"]
    for n in (64, 97):
        x = slice_state["xte"][:n]
        codes = np.asarray(ref_net.quantize_inputs(jnp.asarray(x)))
        want_codes = np.asarray(ref_net.apply_codes(jnp.asarray(codes)))
        want_vals = np.asarray(ref_net(jnp.asarray(x)))
        for engine in ("numpy", "cuda", "cuda-streamed"):
            bit = BitplaneNetwork(slice_state["net"], got, engine=engine,
                                  device="cpu")
            np.testing.assert_array_equal(bit.apply_codes(codes), want_codes)
            np.testing.assert_array_equal(bit(x), want_vals)
            np.testing.assert_array_equal(bit.classify(x, 5),
                                          slice_state["want"][:n])


@pytest.mark.parametrize("backend,engine", [
    ("bitplane", "cuda-streamed"), ("bitplane", "cuda"),
    ("bitplane", "numpy"), ("lut_layer", "numpy"), ("gather", "numpy")])
def test_served_labels_match_reference_gather(slice_state, backend, engine):
    eng = LogicEngine(slice_state["net"], 5, max_batch=128, backend=backend,
                      engine=engine, device="cpu")
    x, want = slice_state["xte"][:N_ROWS], slice_state["want"]
    np.testing.assert_array_equal(eng.classify(x), want)
    # the same stream as 64-row requests through the scheduler
    reqs = [x[i: i + 64] for i in range(0, N_ROWS, 64)]
    results, stats = eng.serve_queue(reqs)
    np.testing.assert_array_equal(np.concatenate(results), want)
    assert stats["p95_us"] >= stats["p50_us"] > 0.0
    if backend == "bitplane":
        agg = eng.scheduler_executor()
        assert agg.n_pad_rows > 0            # ragged flushes were padded


@pytest.mark.parametrize("backend,engine", [
    ("bitplane", "cuda-streamed"), ("bitplane", "cuda"), ("lut_layer", None),
    ("gather", None)])
def test_engine_stages_compose_to_exec_batch(slice_state, backend, engine):
    """``LogicEngine.stages`` splits one batch into stages whose last
    returns ``exec_batch``'s labels; a device engine's ``plane`` and its
    plain version agree on the packed words."""
    eng = LogicEngine(slice_state["net"], 5, max_batch=128, backend=backend,
                      engine=engine, device="cpu")
    x = slice_state["xte"][:97]
    stages = eng.stages(x)
    assert len(stages) == 3
    for fn in stages.values():
        labels = fn()
    np.testing.assert_array_equal(labels, slice_state["want"][:97])
    np.testing.assert_array_equal(labels, eng.exec_batch(x))
    if backend == "bitplane":
        ex = eng.bitnet.executor
        words = stages["quantize+pack"]()
        assert words.shape[1] == 128 // 32        # padded to max_batch
        assert torch.equal(ex.plane(words), ex.plane(words, plain=True))


def test_bitplane_engine_defaults_by_device(slice_state):
    """Without ``engine=`` the bitplane backend runs the streamed kernel
    on a CUDA device and the host fold on the CPU."""
    from repro_torch.synth.executors import default_engine
    assert default_engine(torch.device("cuda")) == "cuda-streamed"
    assert default_engine("cpu") == "numpy"
    eng = LogicEngine(slice_state["net"], 5, max_batch=128,
                      backend="bitplane", device="cpu")
    assert eng.engine == eng.bitnet.engine == "numpy"
    with pytest.raises(ValueError, match="no device stages"):
        eng.stages(slice_state["xte"][:8])


def test_mlp_forward_argmax_agrees(slice_state):
    """The float MLP and its compiled logic agree on the argmax of this
    stream (the reference MLP gives the same scores)."""
    x = slice_state["xte"][:N_ROWS]
    scores = mlp_forward(JSC_S, slice_state["model"], torch.from_numpy(x))
    params, masks, bn = (slice_state[k] for k in ("params", "masks", "bn"))
    ref_scores, _ = ref_mlp.mlp_forward(
        REF_JSC_S, jax.tree.map(jnp.asarray, params),
        [jnp.asarray(m) for m in masks], jax.tree.map(jnp.asarray, bn),
        jnp.asarray(x))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores),
                               rtol=0, atol=1e-6)
    labels = torch.argmax(scores[:, :5], dim=-1).numpy()
    np.testing.assert_array_equal(labels, slice_state["want"])


def test_launcher_serves_carried_weights(slice_state):
    before = launch_counts()
    out = launch_serve.main(["--mode", "logic", "--backend", "lut_layer",
                             "--params", str(slice_state["path"]),
                             "--device", "cpu", "--requests", "2"])
    want = slice_state["want"][:128] == slice_state["yte"][:128]
    assert out["acc"] == pytest.approx(float(np.mean(want)))
    # CPU tensors take the plain versions: no kernel launched
    assert launch_counts() == before
    assert set(out["launches"]) == {"lut_eval", "lut_eval_streamed",
                                    "lut_layer", "aig_sim", "xnor_popcount",
                                    "fanin_matmul", "flash_attention",
                                    "flash_attention_backward",
                                    "decode_attention"}
