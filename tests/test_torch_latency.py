"""The latency twin (``repro_torch.bench.latency``) on the CPU, at a few
training steps and batch 16, against the reference's
``benchmarks/latency.py``: its record keeps the reference's keys, adds
the served walk's row and is stamped with the CPU; each path computes
what the reference's does on the same inputs (the logic path through
weights carried across by ``repro_torch.weights``, the dense path on
the same numpy weights, the xnor path through the reference's kernel in
interpret mode and its ``ref.py``); the kernel paths equal their plain
counterparts."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.jsc import JSC as REF_JSC
from repro.kernels.xnor_popcount import xnor_matmul as ref_xnor_matmul
from repro.kernels.xnor_popcount import xnor_matmul_ref as ref_xnor_ref
from repro.models import mlp as ref_mlp
from repro_torch.bench import latency
from repro_torch.core.logic_infer import classify
from repro_torch.kernels.xnor_popcount import xnor_matmul
from repro_torch.weights import params_to_jax

# the record keys of the reference's benchmarks/latency.py::run
REF_KEYS = {"logic_us", "logic_pallas_us", "dense_float_us", "xnor_us",
            "batch", "logic_vs_dense_x"}
STEPS, BATCH = 5, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    path = tmp_path_factory.mktemp("latency") / "BENCH_latency_torch.json"
    rec = latency.run(steps=STEPS, batch=BATCH, device="cpu", out=str(path))
    return rec, latency.last_run, path


def test_record_keeps_the_reference_keys(record):
    rec, _, _ = record
    assert REF_KEYS <= set(rec)
    for path in latency.PATHS:
        assert rec[f"{path}_us"] > 0
        # no device on the CPU: device µs and queueing not measured
        assert rec[f"{path}_device_us"] is None
        assert rec["device_queued"][path] is None
    assert rec["batch"] == BATCH
    assert rec["logic_vs_dense_x"] == round(
        rec["dense_float_us"] / rec["logic_us"], 2)
    assert rec["train"]["steps"] == STEPS
    assert rec["bitplane_streamed_tile"] == [32, 32]


def test_record_is_stamped_with_the_cpu(record):
    rec, _, path = record
    assert (rec["backend"], rec["device"], rec["power_limit"]) == (
        "cpu", "cpu", None)
    doc = json.loads(path.read_text())
    assert doc["section"] == "latency" and doc["results"] == rec
    assert doc["meta"]["backend"] == "cpu" and doc["meta"]["seed"] == 0


def test_kernel_paths_equal_their_plain_counterparts(record):
    rec, lr, _ = record
    assert rec["identical"] == {"logic_pallas": True, "xnor": True,
                                "bitplane_streamed": True}
    codes = lr.net.quantize_inputs(lr.x)
    want = lr.net.apply_codes(codes)
    assert torch.equal(lr.net.apply_codes(codes, use_kernel=True), want)
    assert torch.equal(lr.net(lr.x, use_kernel=True), lr.net(lr.x))
    np.testing.assert_array_equal(
        lr.bitnet.classify(lr.x, latency.N_CLASSES),
        classify(lr.net, lr.x, latency.N_CLASSES).numpy())


def test_logic_path_matches_the_reference(record):
    """The trained weights carried to the reference package: its
    ``to_logic`` network gives the port's outputs on the same rows."""
    _, lr, _ = record
    params, masks, bn = params_to_jax(lr.model)
    ref_net = ref_mlp.to_logic(
        REF_JSC["jsc-s"], jax.tree.map(jnp.asarray, params),
        [jnp.asarray(m) for m in masks], jax.tree.map(jnp.asarray, bn))
    x = lr.x.numpy()
    want = np.asarray(ref_net(jnp.asarray(x)))
    np.testing.assert_array_equal(lr.net(lr.x).numpy(), want)
    np.testing.assert_array_equal(
        lr.net(lr.x, use_kernel=True).numpy(),
        np.asarray(ref_net(jnp.asarray(x), use_pallas=True)))


def test_xnor_path_matches_the_reference(record):
    _, lr, _ = record
    got = xnor_matmul(torch.sign(lr.x), lr.wq).numpy()
    jx, jw = jnp.sign(jnp.asarray(lr.x.numpy())), jnp.sign(
        jnp.asarray(lr.ws[0].numpy()))
    np.testing.assert_array_equal(got, np.asarray(
        ref_xnor_matmul(jx, jw, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(ref_xnor_ref(jx, jw)))


def test_dense_path_matches_the_reference(record):
    """The reference's ``dense_fn`` (``latency.py:44-49``) on the same
    weights, within 1e-5 x max(1, |ref|)."""
    _, lr, _ = record
    ws_np = latency.dense_weights(lr.cfg, seed=0)
    for w, t in zip(ws_np, lr.ws):
        np.testing.assert_array_equal(t.numpy(), w)
    h = jnp.asarray(lr.x.numpy())
    for w in ws_np:
        h = jax.nn.relu(h @ jnp.asarray(w, jnp.float32).T)
    want = np.asarray(h)
    got = latency.dense_forward(lr.x, lr.ws).numpy()
    assert got.shape == want.shape == (BATCH, lr.cfg.features[-1])
    np.testing.assert_array_less(np.abs(got - want),
                                 1e-5 * np.maximum(1.0, np.abs(want)))


def test_dense_weights_are_seeded(record):
    _, lr, _ = record
    a = latency.dense_weights(lr.cfg, seed=3)
    b = latency.dense_weights(lr.cfg, seed=3)
    assert [w.shape for w in a] == [(64, 16), (32, 64), (5, 32)]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], latency.dense_weights(lr.cfg)[0])
