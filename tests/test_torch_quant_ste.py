"""The port's straight-through quantizers against the reference's
(``repro/core/quant.py``) under ``jax.grad``, on the same numpy inputs,
including inputs exactly at 0, +-1, 0.5 and +-alpha.

Forward values are held bit for bit. Gradients of ``ste_round`` /
``ste_floor`` / ``sign_ste`` / ``binary_ste`` are held exactly (each is
the upstream gradient times 0 or 1). Gradients of ``pact`` /
``signed_uniform`` in ``x`` are exact as well; in ``alpha`` they are a
sum over every element, which the two packages add in different orders,
so they are held within 1e-6 relative (1e-6 absolute near 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as RQ
from repro_torch.core import quant as PQ

ALPHAS = [1.0, 0.75, 1.3]


def _inputs(alpha):
    rng = np.random.default_rng(7)
    edges = [0.0, -0.0, 1.0, -1.0, 0.5, -0.5, alpha, -alpha, 2 * alpha,
             -2 * alpha, 0.25 * alpha]
    x = np.asarray(edges, np.float32)
    x = np.concatenate([x, np.nextafter(x, np.float32(np.inf)),
                        np.nextafter(x, np.float32(-np.inf)),
                        rng.normal(0, 1.5 * alpha, 300).astype(np.float32)])
    # the neighbours of 0 are subnormal: leave them to the flush tests
    return x[np.abs(x) >= np.finfo(np.float32).tiny + (x == 0)]


def _port_grad(fn, x, alpha):
    xt = torch.from_numpy(x).requires_grad_()
    at = torch.tensor(np.float32(alpha), requires_grad=True)
    y = fn(xt, at)
    gx, ga = torch.autograd.grad(y.sum(), (xt, at), allow_unused=True)
    return y.detach().numpy(), gx.numpy(), (None if ga is None
                                            else float(ga))


def _ref_grad(fn, x, alpha):
    y = np.asarray(fn(jnp.asarray(x), jnp.float32(alpha)))
    gx = jax.grad(lambda v: jnp.sum(fn(v, jnp.float32(alpha))))(
        jnp.asarray(x))
    ga = jax.grad(lambda a: jnp.sum(fn(jnp.asarray(x), a)))(
        jnp.float32(alpha))
    return y, np.asarray(gx), float(ga)


@pytest.mark.parametrize("name", ["ste_round", "ste_floor", "sign_ste",
                                  "binary_ste"])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_elementwise_ste_forward_and_gradient_exact(name, alpha):
    x = _inputs(alpha)
    # a non-uniform upstream gradient, so a wrong mask cannot hide
    w = np.linspace(0.5, 2.0, x.size, dtype=np.float32)
    rf, pf = getattr(RQ, name), getattr(PQ, name)
    want = np.asarray(rf(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(
        lambda v: jnp.sum(rf(v) * jnp.asarray(w)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = pf(xt)
    (got_g,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), xt)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got_g.numpy(), want_g)


def test_ste_masks_at_their_edges():
    """sign_ste passes the gradient on |x| <= 1 and binary_ste on
    [0, 1], edges included; sign(0) is +1 and the binary step is at 0.5."""
    x = np.asarray([-1.0, -0.0, 0.0, 0.5, 1.0, 1.0001, -1.0001],
                   np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(PQ.sign_ste(xt).sum(), xt)
    np.testing.assert_array_equal(g.numpy(), [1, 1, 1, 1, 1, 0, 0])
    np.testing.assert_array_equal(PQ.sign_ste(xt).detach().numpy(),
                                  [-1, 1, 1, 1, 1, 1, -1])
    (g,) = torch.autograd.grad(PQ.binary_ste(xt).sum(), xt)
    np.testing.assert_array_equal(g.numpy(), [0, 1, 1, 1, 1, 0, 0])
    np.testing.assert_array_equal(PQ.binary_ste(xt).detach().numpy(),
                                  [0, 0, 0, 1, 1, 1, 0])


QUANTIZERS = [("pact", 2), ("pact", 3), ("signed", 1), ("signed", 2),
              ("signed", 3)]


def _fns(kind, bits):
    if kind == "pact":
        return (lambda x, a: RQ.pact(x, a, bits),
                lambda x, a: PQ.pact(x, a, bits))
    return (lambda x, a: RQ.signed_uniform(x, a, bits),
            lambda x, a: PQ.signed_uniform(x, a, bits))


@pytest.mark.parametrize("kind,bits", QUANTIZERS)
@pytest.mark.parametrize("alpha", ALPHAS)
def test_clip_quantizer_gradients_in_x_and_alpha(kind, bits, alpha):
    x = _inputs(alpha)
    rf, pf = _fns(kind, bits)
    want, want_gx, want_ga = _ref_grad(rf, x, alpha)
    got, got_gx, got_ga = _port_grad(pf, x, alpha)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_gx, want_gx)
    assert got_ga == pytest.approx(want_ga, rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("kind,bits", QUANTIZERS)
def test_clip_gradient_splits_at_the_bounds(kind, bits):
    """At x = 0 (pact) and x = +-alpha both packages give the clipped
    input half the gradient and alpha the other half, element by
    element."""
    alpha = 1.25
    x = np.asarray([0.0, alpha, -alpha], np.float32)
    if kind == "pact":
        x = x[:2]
    rf, pf = _fns(kind, bits)
    for i in range(x.size):
        xi = x[i: i + 1]
        want, want_gx, want_ga = _ref_grad(rf, xi, alpha)
        got, got_gx, got_ga = _port_grad(pf, xi, alpha)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_gx, want_gx)
        assert got_ga == pytest.approx(want_ga, abs=1e-6)
    if bits > 1:
        # the split itself: x = +alpha gets half of the identity gradient
        _, gx, _ = _port_grad(pf, np.asarray([alpha], np.float32), alpha)
        assert gx[0] == 0.5


@pytest.mark.parametrize("kind,bits", [("sign", 1), ("binary", 1),
                                       ("pact", 2), ("signed", 1),
                                       ("signed", 2), ("signed", 3)])
def test_apply_act_quant_gradients(kind, bits):
    """Through the per-layer dispatch (the port flushes subnormals
    first, which passes the gradient of every normal float)."""
    alpha = 0.9
    x = _inputs(alpha)
    rs, ps = RQ.ActQuantSpec(kind, bits), PQ.ActQuantSpec(kind, bits)
    want, want_gx, want_ga = _ref_grad(
        lambda v, a: RQ.apply_act_quant(rs, v, a), x, alpha)
    got, got_gx, got_ga = _port_grad(
        lambda v, a: PQ.apply_act_quant(ps, v, a), x, alpha)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_gx, want_gx)
    assert got_ga == pytest.approx(want_ga, rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 32])
def test_dorefa_weight_forward_and_gradient(bits):
    """Forward within one float32 rounding of the mean / max (1e-6
    relative); gradient within 1e-6 relative for bits=1 (the upstream
    gradient times the mean |w|, summed in another order) and 1e-5
    otherwise (tanh' and the max-normalisation, differently rounded)."""
    rng = np.random.default_rng(bits)
    w = rng.normal(0, 0.5, (12, 9)).astype(np.float32)
    w[0, 0] = 0.0
    up = rng.normal(size=w.shape).astype(np.float32)
    want = np.asarray(RQ.dorefa_weight(jnp.asarray(w), bits))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(
        RQ.dorefa_weight(v, bits) * jnp.asarray(up)))(jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_()
    got = PQ.dorefa_weight(wt, bits)
    (got_g,) = torch.autograd.grad((got * torch.from_numpy(up)).sum(), wt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    if bits == 1:
        np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-6)
    else:
        np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-5,
                                   atol=1e-5 * np.abs(want_g).max())


@pytest.mark.parametrize("kind,bits", [("sign", 1), ("binary", 1),
                                       ("pact", 2), ("pact", 3),
                                       ("signed", 2), ("signed", 3)])
def test_decode_levels(kind, bits):
    rs, ps = RQ.ActQuantSpec(kind, bits), PQ.ActQuantSpec(kind, bits)
    codes = np.random.default_rng(0).integers(0, rs.n_levels, (7, 5))
    want = np.asarray(RQ.decode_levels(rs, jnp.asarray(codes), 1.3))
    got = PQ.decode_levels(ps, torch.from_numpy(codes.astype(np.int32)),
                           1.3)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
