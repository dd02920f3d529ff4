"""The port's mixture-of-experts family (the mixtral-8x22b and dbrx-132b
smokes) against the reference package on the same weights, carried
across with ``weights.lm_params_from_jax``, and the same inputs.

Tolerances as in tests/test_torch_lm.py: float32 within 1e-5 x max(1,
|ref|), bfloat16 within four bf16 steps with the same argmax, the
reference compiled without XLA's excess precision (``STRICT``). The MoE
layer itself is held bit for bit at bfloat16: each token's k weighted
expert outputs are summed in the reference's order (ascending expert,
one rounding an addition), and another order moves some outputs by a
bf16 step, which a tolerance would not see.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as REF_SMOKES
from repro.models import layers as RL
from repro.models import lm as rlm
from repro_torch.configs import SMOKES
from repro_torch.configs.base import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.weights import lm_params_from_jax
from test_torch_lm import (B, DTYPES, F32_TOL, S, STRICT, TOL, _np, close,
                           models, pair, runs)

MOE = ("mixtral-8x22b", "dbrx-132b")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------

def moe_case(case, dtype):
    """(reference cfg, port cfg, reference params, port params, x pair)
    for one layer case."""
    name, kw, shape = {
        # capacity 6 for 12 assignments an expert on average: drops
        "drops": ("mixtral-8x22b", {"capacity_factor": 0.5}, (2, 24, 64)),
        # dbrx's own top-4 of 16 at smoke width, and k = 4 of 8
        "k4": ("dbrx-132b", {"n_experts": 16, "moe_top_k": 4}, (2, 24, 64)),
        "k4of8": ("dbrx-132b", {"n_experts": 8, "moe_top_k": 4}, (2, 24, 64)),
        # the decode step's shape: one token a row
        "decode": ("mixtral-8x22b", {}, (4, 1, 64)),
    }[case]
    rcfg = dataclasses.replace(REF_SMOKES[name], compute_dtype=dtype, **kw)
    cfg = dataclasses.replace(SMOKES[name], compute_dtype=dtype, **kw)
    rp = RL.init_moe(jax.random.PRNGKey(3), rcfg)
    p = lm.Params({k: torch.from_numpy(np.asarray(v)) for k, v in rp.items()})
    xj, xt = pair(np.random.default_rng(4), shape, dtype)
    return rcfg, cfg, rp, p, xj, xt


def kept(cfg, p, x):
    """Kept assignments per token (B, S), from the port's routing."""
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = max(k, int(np.ceil(x.shape[1] * k * cfg.capacity_factor / e)))
    probs = L._softmax(x.float() @ p["router"].float())
    top_e = torch.sort(L.top_k(probs, k)[1], dim=-1)[0]
    order, _, keep = L._routing_indices(top_e, cap, e)
    flat = torch.empty_like(keep).scatter_(1, order, keep)
    return flat.reshape(x.shape[0], x.shape[1], k).sum(-1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["drops", "k4", "k4of8", "decode"])
def test_moe_matches_reference(case, dtype):
    rcfg, cfg, rp, p, xj, xt = moe_case(case, dtype)
    want = jax.jit(lambda x: RL.moe(x, rp, rcfg), compiler_options=STRICT)(xj)
    got = L.moe(xt, p, cfg)
    assert got.dtype == torch_dtype(dtype)
    close(got, want, TOL[dtype], case)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(got), _np(want))
    if case == "drops":
        assert int((kept(cfg, p, xt) < cfg.moe_top_k).sum()) > 0


def test_routing_indices_match_reference():
    """order, slot and keep of every assignment, drops included."""
    rng = np.random.default_rng(5)
    e, k, s, cap = 4, 2, 20, 7
    top_e = np.stack([np.stack([rng.permutation(e)[:k] for _ in range(s)])
                      for _ in range(3)]).astype(np.int32)
    want = RL._routing_indices(jnp.asarray(top_e), s, k, e, cap)
    got = L._routing_indices(torch.from_numpy(top_e).long(), cap, e)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not bool(got[2].all())


def test_top_k_breaks_ties_as_lax_top_k():
    """Equal values: the lower index first, as ``lax.top_k`` gives."""
    x = np.array([[0.25, 0.5, 0.25, 0.5, 0.1, 0.5],
                  [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]], np.float32)
    for k in (1, 2, 4):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = L.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_moe_with_a_zero_router_matches_reference():
    """Every expert equally likely: the ties decide the experts."""
    rcfg, cfg, rp, p, xj, xt = moe_case("k4of8", "float32")
    rp = dict(rp, router=jnp.zeros_like(rp["router"]))
    p.router.zero_()
    close(L.moe(xt, p, cfg), RL.moe(xj, rp, rcfg), F32_TOL, "zero router")


def test_moe_matches_dense_when_experts_identical():
    """Twin of the reference's: all experts sharing weights, top-k MoE
    equals that dense MLP."""
    cfg = dataclasses.replace(SMOKES["mixtral-8x22b"], capacity_factor=4.0)
    p = L.init_moe(torch.Generator().manual_seed(0), cfg)
    for k in ("w1", "w2", "w3"):
        p[k] = p[k][:1].expand_as(p[k]).contiguous()
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    got = L.moe(x, lm.Params(p), cfg)
    want = L.mlp(x, lm.Params({k: p[k][0] for k in ("w1", "w2", "w3")}), cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_moe_capacity_drops_tokens():
    """Twin of the reference's: with tiny capacity, overflow tokens get
    zero output (not NaN)."""
    cfg = dataclasses.replace(SMOKES["mixtral-8x22b"], capacity_factor=0.05)
    p = lm.Params(L.init_moe(torch.Generator().manual_seed(0), cfg))
    x = torch.randn((1, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    out = L.moe(x, p, cfg)
    assert not bool(torch.isnan(out).any())
    assert int((out.abs().sum(-1)[0] == 0).sum()) > 0


# ---------------------------------------------------------------------------
# The LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MOE)
def test_forward_matches_reference(name, dtype):
    ref, got = runs(name, dtype)
    assert got["hidden"].dtype == torch_dtype(dtype)
    close(got["hidden"], ref["hidden"], TOL[dtype], "hidden")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MOE)
def test_prefill_and_decode_step_match_reference(name, dtype):
    """Prefill's logits and cache, then one decode step's logits and
    cache (the port writes it in place)."""
    ref, got = runs(name, dtype)
    for stage in ("prefill", "decode"):
        close(got[stage], ref[stage], TOL[dtype], stage)
        np.testing.assert_array_equal(_np(got[stage]).argmax(-1),
                                      _np(ref[stage]).argmax(-1))
        rc, c = ref[stage + "_cache"], got[stage + "_cache"]
        assert sorted(c) == sorted(rc)
        for key in rc:
            assert tuple(c[key].shape) == rc[key].shape, key
            if key == "positions":
                np.testing.assert_array_equal(c[key].numpy(),
                                              np.asarray(rc[key]))
            else:
                close(c[key], rc[key], TOL[dtype], f"{stage} {key}")


@pytest.mark.parametrize("name", MOE)
def test_decode_matches_forward(name):
    """Twin of the reference's: prefill(x[:S]) + decode_step(x[S]) ==
    forward(x[:S+1])'s last logits at bf16, with capacity factor 8
    (no drops, the regime where the two must agree) and the reference
    test's tolerance and argmax."""
    cfg = dataclasses.replace(SMOKES[name], capacity_factor=8.0)
    p = lm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
    hidden, _, _ = lm.forward(cfg, p, toks)
    want = lm.logits_head(cfg, p, hidden[:, -1]).float().numpy()
    _, cache = lm.prefill(cfg, p, toks[:, :S], max_seq=S + 8)
    got, _ = lm.decode_step(cfg, p, cache, toks[:, S:],
                            torch.full((B,), S, dtype=torch.int32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0.1, atol=0.15)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", MOE)
def test_params_carry_across_and_init_matches_reference_layout(name):
    """``lm_params_from_jax`` keeps every leaf (the router and the
    (E, D, F) / (E, F, D) experts among them); the port's seeded init
    has the reference's leaves and shapes; a wrong depth raises."""
    rcfg, rp, cfg, p = models(name, "bfloat16")
    assert set(p.keys()) == set(rp)
    for i, lp in enumerate(p.layers):
        assert set(lp.keys()) == set(rp["layers"])
        for k, v in rp["layers"]["moe"].items():
            np.testing.assert_array_equal(lp.moe[k].numpy(), np.asarray(v[i]))
    mine = lm.init_params(cfg, torch.Generator().manual_seed(0))
    assert ({n: tuple(t.shape) for n, t in mine.state_dict().items()}
            == {n: tuple(t.shape) for n, t in p.state_dict().items()})
    with pytest.raises(ValueError, match="layers stacked"):
        lm_params_from_jax(dataclasses.replace(cfg, n_layers=3),
                           jax.tree.map(np.asarray, rp))


def test_cast_weights_keeps_the_router_float32():
    """The experts are cast to bf16 once, the router stays float32 (the
    reference computes it in float32), and forward is unchanged bit for
    bit."""
    cfg = SMOKES["mixtral-8x22b"]
    p = lm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.arange(12).reshape(2, 6)
    want = lm.forward(cfg, p, toks)[0]
    lm.cast_weights_(cfg, p)
    moe = p.layers[0].moe
    assert moe.w1.dtype == moe.w2.dtype == moe.w3.dtype == torch.bfloat16
    assert moe.router.dtype == torch.float32
    assert torch.equal(lm.forward(cfg, p, toks)[0], want)


def test_prefill_past_the_window_matches_reference():
    """The prefill cache of a sliding-window MoE model past its window
    (mixtral smoke: window 64) is a window-long ring in both packages."""
    rcfg, rp, cfg, p = models("mixtral-8x22b", "float32")
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, 80)).astype(np.int32)
    want_logits, rc = jax.jit(partial(rlm.prefill, rcfg, rp, max_seq=96),
                              compiler_options=STRICT)(
                                  tokens=jnp.asarray(toks))
    logits, c = lm.prefill(cfg, p, torch.from_numpy(toks), max_seq=96)
    assert c["k"].shape[2] == cfg.window
    close(logits, want_logits, F32_TOL, "logits")
    np.testing.assert_array_equal(c["positions"].numpy(),
                                  np.asarray(rc["positions"]))
    close(c["k"], rc["k"], F32_TOL, "k")
