"""The port's encoder-decoder family (the seamless-m4t-large-v2 smoke)
and the decoder's ``frames`` input against the reference package on the
same weights, carried across with ``weights.lm_params_from_jax``, and
the same inputs: ``encode``, ``forward``, ``prefill(enc_embeds=)`` and
``decode_step`` over the ``enc_out`` cache leaf, the cross-attention
mixer, the cache's layout and the engine's splice of ``enc_out``.

Tolerances as in tests/test_torch_lm.py: float32 within 1e-5 x max(1,
|ref|), bfloat16 within four bf16 steps with the same argmax, the
reference compiled without XLA's excess precision (``STRICT``). The
encoder's frame embeddings are drawn as tests/test_models.py draws
them, normal x 0.1 in bfloat16.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.engine as ref_engine
from repro.configs import SMOKES as REF_SMOKES
from repro.models import lm as rlm
from repro_torch.configs import SMOKES
from repro_torch.configs.base import torch_dtype
from repro_torch.models import lm
from repro_torch.serving.engine import LMEngine
from repro_torch.weights import lm_params_from_jax
from test_torch_lm import (B, DTYPES, F32_TOL, S, STRICT, TOL, _np, close,
                           models, pair)

NAME = "seamless-m4t-large-v2"
FRAMES = (S + 1) // 8          # tests/test_models.py: seq // 8 frames


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def enc_embeds(cfg, batch=B, frames=FRAMES, seed=1):
    """The same bfloat16 frame embeddings as a jnp array and a tensor."""
    e = jnp.asarray(np.random.default_rng(seed).normal(
        size=(batch, frames, cfg.d_model)) * 0.1, jnp.bfloat16)
    return e, torch.from_numpy(np.array(e.astype(jnp.float32))).bfloat16()


_RUNS = {}


def runs(dtype):
    """encode, forward, prefill and one decode_step of both packages on
    the same tokens (B, S + 1) and frame embeddings."""
    if dtype not in _RUNS:
        rcfg, rp, cfg, p = models(NAME, dtype)
        toks = np.random.default_rng(7).integers(
            0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        pos = np.full((B,), S, np.int32)
        ej, et = enc_embeds(cfg)

        @partial(jax.jit, compiler_options=STRICT)
        def reference(t, q, e):
            out = {"enc": rlm.encode(rcfg, rp, e)}
            out["hidden"], out["enc_out"], _ = rlm.forward(
                rcfg, rp, tokens=t, enc_embeds=e)
            out["prefill"], rc = rlm.prefill(rcfg, rp, tokens=t[:, :S],
                                             enc_embeds=e, max_seq=S + 8)
            out["prefill_cache"] = rc
            out["decode"], out["decode_cache"] = rlm.decode_step(
                rcfg, rp, rc, t[:, S:], q)
            return out

        ref = reference(jnp.asarray(toks), jnp.asarray(pos), ej)
        t = torch.from_numpy(toks)
        got = {"enc": lm.encode(cfg, p, et)}
        got["hidden"], got["enc_out"], _ = lm.forward(cfg, p, t,
                                                      enc_embeds=et)
        got["prefill"], c = lm.prefill(cfg, p, t[:, :S], enc_embeds=et,
                                       max_seq=S + 8)
        got["prefill_cache"] = {k: v.clone() for k, v in c.items()}
        got["decode"], got["decode_cache"] = lm.decode_step(
            cfg, p, c, t[:, S:], torch.from_numpy(pos))
        _RUNS[dtype] = ref, got
    return _RUNS[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_reference(dtype):
    ref, got = runs(dtype)
    assert tuple(got["enc"].shape) == (B, FRAMES, SMOKES[NAME].d_model)
    assert got["enc"].dtype == torch_dtype(dtype)
    close(got["enc"], ref["enc"], TOL[dtype], "encode")


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_reference(dtype):
    ref, got = runs(dtype)
    close(got["hidden"], ref["hidden"], TOL[dtype], "hidden")
    close(got["enc_out"], ref["enc_out"], TOL[dtype], "enc_out")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stage", ["prefill", "decode"])
def test_prefill_and_decode_step_match_reference(stage, dtype):
    """Logits and every cache leaf, ``enc_out`` among them, after
    prefill and after one decode step (written in place by the port)."""
    ref, got = runs(dtype)
    close(got[stage], ref[stage], TOL[dtype], "logits")
    np.testing.assert_array_equal(_np(got[stage]).argmax(-1),
                                  _np(ref[stage]).argmax(-1))
    rc, c = ref[stage + "_cache"], got[stage + "_cache"]
    assert sorted(c) == sorted(rc) == ["enc_out", "k", "positions", "v"]
    for key in rc:
        assert tuple(c[key].shape) == rc[key].shape, key
        if key == "positions":
            np.testing.assert_array_equal(c[key].numpy(), np.asarray(rc[key]))
        else:
            close(c[key], rc[key], TOL[dtype], key)


def test_decode_matches_forward():
    """Twin of the reference's: prefill(x[:S]) + decode_step(x[S]) ==
    forward(x[:S+1])'s last logits over the same encoder context, at the
    config's bf16, with the reference test's tolerance and argmax."""
    cfg = SMOKES[NAME]
    p = lm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
    _, et = enc_embeds(cfg, seed=2)
    hidden, _, _ = lm.forward(cfg, p, toks, enc_embeds=et)
    want = lm.logits_head(cfg, p, hidden[:, -1]).float().numpy()
    _, cache = lm.prefill(cfg, p, toks[:, :S], enc_embeds=et, max_seq=S + 8)
    got, _ = lm.decode_step(cfg, p, cache, toks[:, S:],
                            torch.full((B,), S, dtype=torch.int32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0.1, atol=0.15)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_mixer_matches_reference(dtype):
    """Queries of 48 tokens over 6 frames, not causal, no RoPE."""
    rcfg, rp, cfg, p = models(NAME, dtype)
    rng = np.random.default_rng(3)
    xj, xt = pair(rng, (B, S, cfg.d_model), dtype)
    ej, et = pair(rng, (B, FRAMES, cfg.d_model), dtype)
    rc = jax.tree.map(lambda a: a[1], rp["layers"]["cross"])
    want = jax.jit(lambda x, e: rlm._attention_mixer(
        rcfg, rc, x, jnp.arange(S), kv_src=e, causal=False),
        compiler_options=STRICT)(xj, ej)
    got, (k, v) = lm._attention_mixer(cfg, p.layers[1].cross, xt,
                                      torch.arange(S), kv_src=et,
                                      causal=False)
    assert tuple(k.shape) == (B, FRAMES, cfg.n_kv_heads, cfg.head_dim)
    close(got, want, TOL[dtype], "cross attention")


@pytest.mark.parametrize("name", ["glm4-9b", NAME])
def test_frames_branch_matches_reference(name):
    """``frames`` (B, S, D) in place of the token embeddings, for a
    decoder-only model and for the encoder-decoder's decoder: forward
    and prefill, float32."""
    rcfg, rp, cfg, p = models(name, "float32")
    fj, ft = pair(np.random.default_rng(4), (B, S, cfg.d_model))
    kw, tkw = {}, {}
    if cfg.is_encdec:
        kw["enc_embeds"], tkw["enc_embeds"] = enc_embeds(cfg)

    @partial(jax.jit, compiler_options=STRICT)
    def reference(f, kw):
        return (rlm.forward(rcfg, rp, frames=f, **kw)[0],
                rlm.prefill(rcfg, rp, frames=f, max_seq=S + 8, **kw)[0])

    hidden, logits = reference(fj, kw)
    close(lm.forward(cfg, p, frames=ft, **tkw)[0], hidden, F32_TOL, "hidden")
    close(lm.prefill(cfg, p, frames=ft, max_seq=S + 8, **tkw)[0], logits,
          F32_TOL, "logits")


def test_forward_without_enc_embeds_raises():
    """Where the reference asserts, the port names what is missing."""
    cfg = SMOKES[NAME]
    p = lm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 4), dtype=torch.int32)
    for call in (lambda: lm.forward(cfg, p, toks),
                 lambda: lm.prefill(cfg, p, toks, max_seq=8)):
        with pytest.raises(ValueError, match="enc_embeds"):
            call()


def test_params_carry_across_and_init_matches_reference_layout():
    """``lm_params_from_jax`` keeps every leaf of both stacks
    (``enc_layers`` ``n_enc_layers`` deep, ``cross``, ``ln_cross``,
    ``enc_norm``); the port's seeded init has the reference's leaves
    and shapes; a wrong depth of either stack raises."""
    rcfg, rp, cfg, p = models(NAME, "bfloat16")
    assert set(p.keys()) == set(rp)
    for stack in ("layers", "enc_layers"):
        for i, lp in enumerate(p[stack]):
            assert set(lp.keys()) == set(rp[stack])
            for key, sub in rp[stack].items():
                if isinstance(sub, dict):
                    for k, v in sub.items():
                        np.testing.assert_array_equal(lp[key][k].numpy(),
                                                      np.asarray(v[i]))
                else:
                    np.testing.assert_array_equal(lp[key].numpy(),
                                                  np.asarray(sub[i]))
    np.testing.assert_array_equal(p.enc_norm.numpy(),
                                  np.asarray(rp["enc_norm"]))
    mine = lm.init_params(cfg, torch.Generator().manual_seed(0))
    assert ({n: tuple(t.shape) for n, t in mine.state_dict().items()}
            == {n: tuple(t.shape) for n, t in p.state_dict().items()})
    tree = jax.tree.map(np.asarray, rp)
    for kw, what in (({"n_layers": 3}, "layers"),
                     ({"n_enc_layers": 3}, "enc_layers")):
        with pytest.raises(ValueError, match=f"^{what} stacked"):
            lm_params_from_jax(dataclasses.replace(cfg, **kw), tree)


def test_cast_weights_casts_the_encoder_and_cross_attention():
    cfg = SMOKES[NAME]
    p = lm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.arange(12).reshape(2, 6)
    _, et = enc_embeds(cfg, batch=2, frames=3)
    want = lm.forward(cfg, p, toks, enc_embeds=et)[0]
    lm.cast_weights_(cfg, p)
    assert p.layers[0].cross.wq.dtype == torch.bfloat16
    assert p.enc_layers[0].attn.wk.dtype == p.enc_layers[0].mlp.w2.dtype \
        == torch.bfloat16
    assert p.layers[0].ln_cross.dtype == p.enc_norm.dtype == torch.float32
    assert torch.equal(lm.forward(cfg, p, toks, enc_embeds=et)[0], want)


def test_init_cache_matches_reference():
    rcfg, _, cfg, _ = models(NAME, "bfloat16")
    want = jax.eval_shape(lambda: rlm.init_cache(rcfg, 3, 20, enc_frames=5))
    got = lm.init_cache(cfg, 3, 20, enc_frames=5)
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        assert tuple(got[key].shape) == leaf.shape, key
        assert str(got[key].dtype)[6:] == str(leaf.dtype), key


def test_splice_slot_of_enc_out_matches_reference():
    """The engine's splice writes the admitted slot's rows of every leaf,
    ``enc_out`` (B, F, D) among them, as the reference's does."""
    _, _, cfg, p = models(NAME, "float32")
    rng = np.random.default_rng(6)
    pool = lm.init_cache(cfg, 3, 16, enc_frames=FRAMES)
    for v in pool.values():
        v.copy_(torch.from_numpy(rng.normal(size=v.shape)).to(v.dtype))
    single = {k: torch.from_numpy(rng.normal(size=(v.shape[0], 1)
                                             + v.shape[2:])).to(v.dtype)
              if k in ("k", "v") else
              torch.from_numpy(rng.normal(size=(1,) + v.shape[1:])).to(
                  v.dtype) for k, v in pool.items()}

    def as_jnp(tree):
        return {k: jnp.asarray(v.float().numpy()).astype(str(v.dtype)[6:])
                for k, v in tree.items()}

    want = ref_engine.LMEngine._splice_slot(as_jnp(pool), as_jnp(single), 1)
    LMEngine._splice_slot(pool, single, 1)
    for key, leaf in want.items():
        np.testing.assert_array_equal(_np(pool[key]), _np(leaf))
