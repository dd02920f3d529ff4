"""The port's fanin-constrained pruning against the reference's
(``repro/core/fcp.py``, ``repro/models/mlp.py``) on the same numpy
weights: the gradual schedule's budget at every step, and every mask
and projection, all exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.jsc import JSC_S as REF_JSC_S
from repro.core import fcp as RF
from repro.models import mlp as ref_mlp
from repro_torch.configs.jsc import JSC_S
from repro_torch.core import fcp as PF
from repro_torch.models.mlp import update_masks_gradual
from repro_torch.weights import params_from_jax

SCHEDULES = [(3, 0, 1000, 50), (3, 100, 280, 25), (4, 10, 37, 25),
             (3, 3, 3, 25), (2, 5, 6, 25), (6, 17, 490, 25)]


@pytest.mark.parametrize("target,begin,end,freq", SCHEDULES)
@pytest.mark.parametrize("in_dim", [5, 16, 64, 700])
def test_gradual_fanin_at_every_step(target, begin, end, freq, in_dim):
    r = RF.GradualFCP(target, begin, end, freq)
    p = PF.GradualFCP(target, begin, end, freq)
    want = [int(r.fanin_at(s, in_dim)) for s in range(end + 11)]
    got = [p.fanin_at(s, in_dim) for s in range(end + 11)]
    assert got == want
    assert got[-1] == target


def _weights(seed, shape, ties=False):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32)
    if ties:  # equal magnitudes: the index tie-break decides
        w[:, ::3] = np.float32(0.5) * np.sign(w[:, ::3])
    return w


@pytest.mark.parametrize("shape", [(8, 16), (64, 16), (5, 32)])
@pytest.mark.parametrize("ties", [False, True])
def test_update_mask_and_projection(shape, ties):
    w = _weights(shape[0], shape, ties)
    r, p = RF.GradualFCP(3, 10, 60, 25), PF.GradualFCP(3, 10, 60, 25)
    for step in (0, 10, 25, 35, 50, 60, 70):
        np.testing.assert_array_equal(
            p.update_mask(torch.from_numpy(w), step).numpy(),
            np.asarray(r.update_mask(jnp.asarray(w), step)))
    for k in (1, 3, shape[1]):
        got = PF.project_fanin(torch.from_numpy(w), k).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(RF.project_fanin(jnp.asarray(w), k)))
        np.testing.assert_array_equal(
            PF.row_fanins(torch.from_numpy(got)).numpy(),
            np.asarray(RF.row_fanins(jnp.asarray(got))))


@pytest.mark.parametrize("target", [2, 3, 4])
def test_admm_state_updates_and_penalty(target):
    """init_state, five dual updates on moving weights, the penalty and
    finalize: Z, U and masks exact; the penalty (a sum of squares in
    another order) within 1e-6 relative."""
    r = RF.AdmmFCP(target, rho=5e-3, dual_freq=50)
    p = PF.AdmmFCP(target, rho=5e-3, dual_freq=50)
    w = _weights(target, (32, 16))
    rz, ru = r.init_state(jnp.asarray(w))
    pz, pu = p.init_state(torch.from_numpy(w))
    rng = np.random.default_rng(1)
    for _ in range(5):
        np.testing.assert_array_equal(pz.numpy(), np.asarray(rz))
        np.testing.assert_array_equal(pu.numpy(), np.asarray(ru))
        assert float(p.penalty(torch.from_numpy(w), pz, pu)) == \
            pytest.approx(float(r.penalty(jnp.asarray(w), rz, ru)),
                          rel=1e-6)
        w = w + rng.normal(scale=0.1, size=w.shape).astype(np.float32)
        rz, ru = r.dual_update(jnp.asarray(w), rz, ru)
        pz, pu = p.dual_update(torch.from_numpy(w), pz, pu)
    rw, rm = r.finalize(jnp.asarray(w))
    pw, pm = p.finalize(torch.from_numpy(w))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(rw))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))


@pytest.mark.parametrize("step", [0, 30, 60, 90, 120])
def test_update_masks_gradual_per_layer(step):
    """JSC-S, each layer at its own target fanin (the trainer's
    schedule for 400 steps: begin 100, end 280, every 25)."""
    params = jax.tree.map(np.asarray, ref_mlp.init_mlp_params(
        REF_JSC_S, jax.random.PRNGKey(step)))
    masks = [np.asarray(m) for m in ref_mlp.init_masks(REF_JSC_S)]
    bn = jax.tree.map(np.asarray, ref_mlp.init_bn_state(REF_JSC_S))
    model = params_from_jax(params, masks, bn)
    r = RF.GradualFCP(0, 100, 280, 25)
    p = PF.GradualFCP(0, 100, 280, 25)
    step = 100 + step
    want = ref_mlp.update_masks_gradual(
        REF_JSC_S, jax.tree.map(jnp.asarray, params), step, r)
    got = update_masks_gradual(JSC_S, model, step, p)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert dataclasses.replace(p, target_fanin=3).fanin_at(280, 64) == 3
