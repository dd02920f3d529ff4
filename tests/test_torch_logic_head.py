"""The ``logic_head`` example twin (``repro_torch.examples.logic_head``)
against the reference's ``examples/logic_head.py``, whose steps are
written out here with the reference's functions (the example is a
script that runs at import).

At reduced sizes (N_TRAIN_R + N_TEST_R sequences of S_R tokens, the
head trained STEPS_R steps) and on the reference's hymba smoke weights
carried across (``weights.lm_params_from_jax``):

  * the pooled features: the port's ``lm.forward`` rounds where the
    program rounds, and the reference's example runs ``lm.forward``
    eagerly, its layer scan compiled with XLA's defaults, which keep
    float32 inside some bf16 fusions (tests/test_torch_lm.py). The mean
    of bf16 hidden states is itself bf16 in both. So the features are
    held within BF16_XLA_TOL = 8 bf16 steps x max(1, |ref|), the
    tolerance tests/test_torch_lm.py holds the hidden states to
    (measured 0.0137);
  * the standardisation and the teacher's labels: the same numpy code,
    equal on equal features;
  * both trainers on the reference's features, from the reference's
    head init (``weights.params_from_jax``): the masks equal, the LUT
    count equal, the port's head and its logic network bit-exact on the
    test rows, and the test accuracy within ACC_BAND = 0.02 of the
    reference's (measured 0.0033: the trainers part only in the bias
    under BN, whose gradient is rounding noise, tests/test_torch_train.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core.logic_infer import hardware_report as ref_hardware_report
from repro.models import lm as rlm
from repro.models import mlp as ref_mlp
from repro.train import jsc_trainer as ref_trainer
from repro_torch.configs import get_arch
from repro_torch.core.logic_infer import hardware_report
from repro_torch.device import NoCudaDeviceError
from repro_torch.examples import logic_head as LH
from repro_torch.models.mlp import mlp_forward, to_logic
from repro_torch.train.jsc_trainer import train_jsc
from repro_torch.weights import lm_params_from_jax, params_from_jax

N_TRAIN_R, N_TEST_R, S_R, STEPS_R = 600, 300, 16, 100
BF16_XLA_TOL = 8 * 2.0 ** -7       # tests/test_torch_lm.py's
ACC_BAND = 0.02


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def features():
    """(reference features, port features) of the same tokens, drawn as
    the example draws them, from the reference's seed-0 weights."""
    rcfg = ref_get_arch("hymba-1.5b", smoke=True)
    cfg = get_arch("hymba-1.5b", smoke=True)
    rp = rlm.init_params(rcfg, jax.random.PRNGKey(0))
    params = lm_params_from_jax(cfg, jax.tree.map(np.asarray, rp))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (N_TRAIN_R + N_TEST_R, S_R), dtype=np.int32)
    # the reference example's featurize, over its batches of 250
    want = np.concatenate([
        np.asarray(jnp.mean(rlm.forward(rcfg, rp, tokens=jnp.asarray(
            tokens[i:i + LH.BATCH]))[0], axis=1), np.float32)
        for i in range(0, len(tokens), LH.BATCH)])
    got = LH.pooled_features(cfg, params, tokens)
    return want, got


def test_features_match_reference(features):
    want, got = features
    assert got.dtype == np.float32 and got.shape == want.shape == (
        N_TRAIN_R + N_TEST_R, get_arch("hymba-1.5b", smoke=True).d_model)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert float(err.max()) <= BF16_XLA_TOL, float(err.max())


def test_standardise_and_label_is_the_reference_example(features):
    want, _ = features
    feats, labels = LH.standardise_and_label(want)
    ref = (want - want.mean(0)) / (want.std(0) + 1e-6)
    teacher = np.random.default_rng(7).normal(size=(ref.shape[1], 4))
    np.testing.assert_array_equal(feats, ref)
    np.testing.assert_array_equal(labels, (ref @ teacher).argmax(-1))
    assert labels.dtype == np.int32


def _ref_head_cfg(n_inputs):
    return ref_mlp.MLPConfig(
        name="lm-head", n_inputs=n_inputs, features=(24, 12, 4),
        fanins=(4, 4, 4), act_bits=(2, 2, 3), in_bits=2, n_classes=4,
        alpha=1.0)


def test_head_config_is_the_reference_example():
    got = dataclasses.asdict(LH.head_config(64))
    assert got == dataclasses.asdict(_ref_head_cfg(64))


def test_both_trainers_on_reference_features(features):
    want_feats, _ = features
    feats, labels = LH.standardise_and_label(want_feats)
    data = ((feats[:N_TRAIN_R], labels[:N_TRAIN_R]),
            (feats[N_TRAIN_R:], labels[N_TRAIN_R:]))
    rcfg = _ref_head_cfg(feats.shape[1])
    head = LH.head_config(feats.shape[1])
    want = ref_trainer.train_jsc(rcfg, steps=STEPS_R, data=data)
    init = params_from_jax(*(
        jax.tree.map(np.asarray, x) for x in (
            ref_mlp.init_mlp_params(rcfg, jax.random.PRNGKey(0)),
            ref_mlp.init_masks(rcfg), ref_mlp.init_bn_state(rcfg))))
    got = train_jsc(head, steps=STEPS_R, data=data, init=init, device="cpu")
    for m, rm in zip(got.masks, want.masks):
        np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
    assert abs(got.test_acc - want.test_acc) <= ACC_BAND

    net = to_logic(head, got.model)
    ref_net = ref_mlp.to_logic(rcfg, want.params, want.masks, want.bn_state)
    assert hardware_report(net)[0].luts == ref_hardware_report(ref_net)[0].luts
    x = torch.from_numpy(feats[N_TRAIN_R:N_TRAIN_R + LH.N_CHECK])
    np.testing.assert_array_equal(
        torch.argmax(mlp_forward(head, got.model, x)[:, :4], -1).numpy(),
        torch.argmax(net(x, use_kernel=True)[:, :4], -1).numpy())


def test_run_is_bit_exact_on_the_cpu():
    """The twin's whole flow at reduced sizes on the CPU (plain
    versions of the flash and lut_layer kernels), from the port's own
    seeded weights."""
    cfg = get_arch("hymba-1.5b", smoke=True)
    from repro_torch.models import lm
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    out = LH.run(cfg, params, n_train=N_TRAIN_R, n_test=N_TEST_R, seq=S_R,
                 steps=STEPS_R, log=lambda *_: None)
    assert out["bit_exact"]
    assert out["features"].shape == (N_TRAIN_R + N_TEST_R, cfg.d_model)
    assert out["luts"] > 0 and out["ffs"] > 0 and out["test_acc"] > 0.25


def test_main_needs_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        LH.main([])


def test_main_on_the_cpu_within_bands_of_the_reference_run():
    """The example as ``main`` runs it (full sizes, the port's seed-0
    weights), on the CPU: bit-exact, and the accuracy, LUTs and FFs of
    the reference's own run within the twin's stated bands."""
    out = LH.main(["--device", "cpu"])
    assert out["bit_exact"]
    assert LH.within_reference_bands(out), (
        out["test_acc"], out["luts"], out["ffs"])
